"""Dependency-free metrics plane: counters, gauges, histograms, rates —
the port of ``metis_tpu/obs/metrics.py``, with the reference's metric
names and label sets (``METRIC_CATALOG``).

The flight recorder (:mod:`metis_tpu_torch.core.trace`) answers *what happened
on one run* — spans, heartbeats, counter totals drained to a JSONL file.
This module answers *how is the system doing right now*: latency
distributions, ratios, and rates a long-lived daemon exposes on
``GET /metrics`` in Prometheus text exposition format, stdlib only.

Four instrument kinds, all thread-safe and all registered in a
:class:`MetricsRegistry`:

- :class:`Counter` — monotonic, float-valued (device-hours accumulate in
  fractions).
- :class:`Gauge` — set/inc/dec a point-in-time value.
- :class:`Histogram` — log-bucketed streaming distribution.  Buckets are
  geometric (``_BUCKET_FACTOR`` per step, ~12%/bucket), so
  :meth:`Histogram.quantile` is exact to within one bucket's relative
  width at any scale from microseconds to hours, with O(buckets) memory
  regardless of sample count.  Mergeable across processes like
  ``core.trace.Counters.merge`` — the parallel-search workers' dict
  round-trip (:meth:`Histogram.to_dict` / :meth:`Histogram.merge_dict`)
  is associative and commutative, so shard accounting folds in any
  order.
- :class:`RateMeter` — rolling-window event rate (the dashboard's qps),
  rendered as a gauge.

``render_prometheus`` / ``parse_exposition`` are inverse enough that the
``top`` dashboard consumes the daemon's own scrape output rather than
reaching into process state.  ``METRIC_CATALOG`` is the documented
contract: every metric any subsystem exports, the reference's catalog
entry for entry (``tests/test_torch_metrics_names.py`` holds the two
equal and a live scrape inside it).
"""
from __future__ import annotations

import bisect
import math
import re
import threading
import time
from typing import Any, Iterable

# ---------------------------------------------------------------------------
# log-spaced default buckets: 20 per decade over 1e-6 .. 1e9 (any latency
# from nanoseconds-in-ms-units up to days-in-seconds lands in-range), so a
# quantile estimate is within one bucket = within ~12% relative error
# ---------------------------------------------------------------------------

_BUCKETS_PER_DECADE = 20
_BUCKET_FACTOR = 10.0 ** (1.0 / _BUCKETS_PER_DECADE)
_BUCKET_LO_EXP = -6
_BUCKET_HI_EXP = 9


def _default_bounds() -> tuple[float, ...]:
    n = (_BUCKET_HI_EXP - _BUCKET_LO_EXP) * _BUCKETS_PER_DECADE + 1
    return tuple(10.0 ** (_BUCKET_LO_EXP + i / _BUCKETS_PER_DECADE)
                 for i in range(n))


DEFAULT_BOUNDS = _default_bounds()


class Counter:
    """Monotonic counter.  ``inc`` with a negative amount raises — the
    monotonicity is what lets scrape deltas be trusted as rates."""

    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value: set / inc / dec."""

    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Log-bucketed streaming histogram.

    ``observe(v)`` is a bisect + two adds under a lock — cheap enough for
    per-request recording on the serve daemon's cached-hit path.  Values
    at or below the smallest bound land in bucket 0; values above the
    largest land in the overflow (``+Inf``) bucket.  Exact ``count``,
    ``sum``, ``min``, ``max`` ride alongside the buckets, so quantile
    estimates can be clamped to the observed range (a constant sample's
    p50 is exact, not a bucket edge)."""

    __slots__ = ("bounds", "_counts", "count", "sum", "min", "max", "_lock")

    def __init__(self, bounds: Iterable[float] | None = None):
        self.bounds: tuple[float, ...] = (tuple(bounds) if bounds is not None
                                          else DEFAULT_BOUNDS)
        if list(self.bounds) != sorted(self.bounds) or not self.bounds:
            raise ValueError("histogram bounds must be sorted and non-empty")
        self._counts = [0] * (len(self.bounds) + 1)  # last = overflow/+Inf
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    # -- quantiles ----------------------------------------------------------
    def quantile(self, q: float) -> float | None:
        """Nearest-rank quantile estimate, exact to within one bucket's
        relative width (``numpy.quantile(..., method="inverted_cdf")`` is
        the test oracle).  None on an empty histogram."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            n = self.count
            if n == 0:
                return None
            target = max(1, math.ceil(q * n))
            cum = 0
            idx = len(self._counts) - 1
            for i, c in enumerate(self._counts):
                cum += c
                if cum >= target:
                    idx = i
                    break
            lo = self.bounds[idx - 1] if idx > 0 else self.min
            hi = self.bounds[idx] if idx < len(self.bounds) else self.max
            # geometric midpoint suits log buckets; clamp to the observed
            # range so degenerate samples stay exact
            if lo > 0 and hi > 0 and math.isfinite(lo) and math.isfinite(hi):
                est = math.sqrt(lo * hi)
            else:
                est = hi if math.isfinite(hi) else lo
            return min(max(est, self.min), self.max)

    # -- merging (Counters.merge-style, associative + commutative) ----------
    def merge(self, other: "Histogram") -> None:
        """Fold another histogram (same bounds) into this one."""
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different bounds")
        with other._lock:
            counts = list(other._counts)
            count, total = other.count, other.sum
            mn, mx = other.min, other.max
        self._merge_parts(counts, count, total, mn, mx)

    def merge_dict(self, d: dict) -> None:
        """Fold a :meth:`to_dict` snapshot (how a worker process ships its
        shard's distribution home, like ``Counters.merge``)."""
        counts = [0] * (len(self.bounds) + 1)
        for i, c in d.get("counts", {}).items():
            counts[int(i)] = int(c)
        self._merge_parts(counts, int(d.get("count", 0)),
                          float(d.get("sum", 0.0)),
                          float(d.get("min", math.inf)),
                          float(d.get("max", -math.inf)))

    def _merge_parts(self, counts, count, total, mn, mx) -> None:
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self.count += count
            self.sum += total
            if mn < self.min:
                self.min = mn
            if mx > self.max:
                self.max = mx

    def to_dict(self) -> dict:
        """JSON-safe sparse snapshot (bucket index -> count)."""
        with self._lock:
            return {
                "counts": {str(i): c for i, c in enumerate(self._counts)
                           if c},
                "count": self.count,
                "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
            }

    def cumulative_buckets(self) -> list[tuple[float, int]]:
        """``(le_bound, cumulative_count)`` pairs for exposition: only
        buckets where the cumulative count changes, plus the ``+Inf``
        terminator (valid Prometheus histogram — every rendered bucket is
        cumulative and ``+Inf`` equals ``count``)."""
        out: list[tuple[float, int]] = []
        with self._lock:
            cum = 0
            for i, c in enumerate(self._counts[:-1]):
                cum += c
                if c:
                    out.append((self.bounds[i], cum))
            out.append((math.inf, self.count))
        return out


class RateMeter:
    """Rolling-window event rate.

    ``mark(n)`` buckets events into fixed time slots; :meth:`rate` sums
    the slots still inside the window and divides by the window actually
    covered (so a meter younger than its window reports an honest rate
    instead of diluting by unlived time)."""

    __slots__ = ("window_s", "_slot_s", "_counts", "_epochs", "_t0",
                 "total", "_lock")

    def __init__(self, window_s: float = 60.0, slots: int = 15):
        if window_s <= 0 or slots < 1:
            raise ValueError("window_s must be > 0 and slots >= 1")
        self.window_s = float(window_s)
        self._slot_s = self.window_s / slots
        self._counts = [0.0] * slots
        self._epochs = [-1] * slots
        self._t0 = time.monotonic()
        self.total = 0.0
        self._lock = threading.Lock()

    def mark(self, n: float = 1.0) -> None:
        now = time.monotonic()
        epoch = int(now / self._slot_s)
        i = epoch % len(self._counts)
        with self._lock:
            if self._epochs[i] != epoch:
                self._epochs[i] = epoch
                self._counts[i] = 0.0
            self._counts[i] += n
            self.total += n

    def rate(self) -> float:
        now = time.monotonic()
        epoch = int(now / self._slot_s)
        horizon = epoch - len(self._counts) + 1
        with self._lock:
            live = sum(c for c, e in zip(self._counts, self._epochs)
                       if e >= horizon)
        covered = min(self.window_s, max(now - self._t0, self._slot_s))
        return live / covered


class _NullInstrument:
    """Shared no-op standing in for every instrument kind on a disabled
    registry, so instrumented call sites never guard."""

    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def mark(self, n: float = 1.0) -> None:
        pass

    def quantile(self, q: float) -> None:
        return None

    def rate(self) -> float:
        return 0.0

    @property
    def value(self) -> float:
        return 0.0


NULL_INSTRUMENT = _NullInstrument()


# ---------------------------------------------------------------------------
# the documented contract: every metric the codebase exports, equal to
# the reference's catalog; scraped /metrics names are a subset of it.
# ---------------------------------------------------------------------------

METRIC_CATALOG: dict[str, tuple[str, str, tuple[str, ...]]] = {
    # name -> (type, help, label names)
    "metis_serve_requests_total": (
        "counter", "HTTP requests completed, per endpoint", ("endpoint",)),
    "metis_serve_errors_total": (
        "counter", "HTTP responses with status >= 400, per endpoint",
        ("endpoint",)),
    "metis_serve_request_latency_ms": (
        "histogram", "wall time per HTTP request, per endpoint",
        ("endpoint",)),
    "metis_serve_qps": (
        "gauge", "rolling 60s request rate across all endpoints", ()),
    "metis_serve_inflight_requests": (
        "gauge", "HTTP requests currently executing", ()),
    "metis_serve_queue_depth": (
        "gauge", "threads holding or waiting on the search lock", ()),
    "metis_serve_coalesced_waits_total": (
        "counter", "plan queries that waited behind a single-flight "
                   "leader instead of searching", ()),
    "metis_serve_coalesced_wait_ms": (
        "histogram", "time followers spent waiting for the single-flight "
                     "leader's search", ()),
    "metis_serve_cache_hits_total": (
        "counter", "plan cache lookups answered from cache", ()),
    "metis_serve_cache_misses_total": (
        "counter", "plan cache lookups that missed", ()),
    "metis_serve_cache_hit_ratio": (
        "gauge", "hits / (hits + misses) over daemon lifetime", ()),
    "metis_serve_cache_entries": (
        "gauge", "plan cache occupancy (entries)", ()),
    "metis_serve_cache_capacity": (
        "gauge", "plan cache capacity (entries)", ()),
    "metis_serve_cache_evictions_total": (
        "counter", "plan cache LRU evictions", ()),
    "metis_serve_cache_invalidations_total": (
        "counter", "plan cache entries dropped by drift alarms, deltas, "
                   "or explicit invalidation", ()),
    "metis_serve_cache_shard_lock_wait_ms": (
        "histogram", "time blocked acquiring one plan-cache shard lock "
                     "(uncontended acquires are not timed)", ("shard",)),
    "metis_serve_keepalive_reuse_total": (
        "counter", "HTTP requests served on an already-open keep-alive "
                   "connection (2nd and later request per connection)",
        ()),
    "metis_serve_pool_threads": (
        "gauge", "handler worker-pool size", ()),
    "metis_serve_pool_busy_threads": (
        "gauge", "handler pool threads currently serving a connection",
        ()),
    "metis_serve_pool_backlog": (
        "gauge", "accepted connections queued for a free pool thread",
        ()),
    "metis_serve_pool_queue_wait_ms": (
        "histogram", "time an accepted connection waited in the backlog "
                     "before a pool thread picked it up", ()),
    "metis_serve_overload_total": (
        "counter", "connections shed with 503 + Retry-After because the "
                   "worker pool and its backlog were both full", ()),
    "metis_search_pool_workers": (
        "gauge", "resident cold-search worker processes (0 = pool off or "
                 "closed)", ()),
    "metis_search_pool_inflight": (
        "gauge", "searches currently executing on the worker pool", ()),
    "metis_serve_warm_states": (
        "gauge", "retained warm search states", ()),
    "metis_serve_notes_backlog": (
        "gauge", "notifications held for long-poll subscribers", ()),
    "metis_serve_uptime_seconds": (
        "gauge", "seconds since the daemon booted", ()),
    "metis_serve_tenants": (
        "gauge", "registered tenants", ()),
    "metis_snapshot_age_seconds": (
        "gauge", "seconds since the last durable state snapshot was "
                 "written (staleness = the periodic snapshotter is "
                 "failing)", ()),
    "metis_snapshot_size_bytes": (
        "gauge", "size of the last written state snapshot", ()),
    "metis_oplog_appends_total": (
        "counter", "state-mutation ops appended to the oplog", ()),
    "metis_standby_oplog_lag": (
        "gauge", "ops the standby still trails the primary by "
                 "(0 once caught up or promoted)", ()),
    "metis_search_duration_seconds": (
        "histogram", "end-to-end search time per cold plan query",
        ("kind",)),
    "metis_search_phase_seconds": (
        "histogram", "serial hetero search phase durations "
                     "(setup/enumeration/intra_stage/costing/ranking)",
        ("phase",)),
    "metis_fleet_utilization_frac": (
        "gauge", "devices allocated / fleet devices, last fleet plan", ()),
    "metis_fleet_objective": (
        "gauge", "priority-weighted utility objective of the last fleet "
                 "plan", ()),
    "metis_fleet_tenant_utilization_frac": (
        "gauge", "per-tenant utility vs full-fleet baseline, last fleet "
                 "plan", ("tenant",)),
    "metis_fleet_tenant_devices": (
        "gauge", "devices carved to the tenant in the last fleet plan",
        ("tenant",)),
    "metis_fleet_preemptions_total": (
        "counter", "capacity-change shrinks of a tenant's carve",
        ("tenant",)),
    "metis_replay_slo_attainment": (
        "gauge", "request-weighted SLO attainment of the running traffic "
                 "replay", ("policy",)),
    "metis_replay_device_hours_total": (
        "counter", "provisioned device-hours accumulated by the traffic "
                   "replay", ("policy",)),
    "metis_replay_ticks_total": (
        "counter", "traffic-replay ticks simulated", ("policy",)),
    "metis_plan_confidence_p": (
        "gauge", "confidence p of the last exact-backend certificate "
                 "(probability the certified plan is truly optimal "
                 "under the ledger-fit residual model)", ()),
    "metis_transfer_scale_factor": (
        "gauge", "roofline time-scale factor applied to transferred "
                 "(unprofiled-device) profiles", ("target_type",)),
}


_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class MetricsRegistry:
    """Instrument registry + Prometheus text renderer.

    ``registry.counter(name, **labels)`` returns the one Counter for that
    (name, labels) pair, creating it on first use — call sites fetch and
    record in one line, and repeat fetches are a dict lookup.  A name is
    permanently bound to one instrument kind (mixing kinds under one name
    raises).  ``MetricsRegistry(enabled=False)`` (or :data:`NULL_METRICS`)
    returns shared no-op instruments so instrumented code costs nothing
    when telemetry is off — the bench's metrics-overhead baseline."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._metrics: dict[tuple[str, tuple], Any] = {}
        self._kinds: dict[str, str] = {}
        self._help: dict[str, str] = {}

    # -- instrument accessors -----------------------------------------------
    def _get(self, kind: str, name: str, help_text: str, factory,
             labels: dict[str, str]):
        if not self.enabled:
            return NULL_INSTRUMENT
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name: {name!r}")
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"bad label name: {k!r}")
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        with self._lock:
            inst = self._metrics.get(key)
            if inst is not None:
                if self._kinds[name] != kind:
                    raise ValueError(
                        f"metric {name!r} is a {self._kinds[name]}, "
                        f"not a {kind}")
                return inst
            prev = self._kinds.get(name)
            if prev is not None and prev != kind:
                raise ValueError(
                    f"metric {name!r} is a {prev}, not a {kind}")
            inst = factory()
            self._metrics[key] = inst
            self._kinds[name] = kind
            if name not in self._help:
                cat = METRIC_CATALOG.get(name)
                self._help[name] = help_text or (cat[1] if cat else "")
            return inst

    def counter(self, name: str, help: str = "", **labels: str) -> Counter:
        return self._get("counter", name, help, Counter, labels)

    def gauge(self, name: str, help: str = "", **labels: str) -> Gauge:
        return self._get("gauge", name, help, Gauge, labels)

    def histogram(self, name: str, help: str = "",
                  bounds: Iterable[float] | None = None,
                  **labels: str) -> Histogram:
        return self._get("histogram", name, help,
                         lambda: Histogram(bounds=bounds), labels)

    def rate(self, name: str, help: str = "", window_s: float = 60.0,
             **labels: str) -> RateMeter:
        # rendered as a gauge: the sample is the instantaneous rate
        return self._get("rate", name, help,
                         lambda: RateMeter(window_s=window_s), labels)

    # -- introspection ------------------------------------------------------
    def names(self) -> set[str]:
        with self._lock:
            return set(self._kinds)

    def snapshot(self) -> dict:
        """Nested JSON-safe dump: name -> list of {labels, ...values}."""
        out: dict[str, list] = {}
        with self._lock:
            items = list(self._metrics.items())
            kinds = dict(self._kinds)
        for (name, labelkey), inst in items:
            kind = kinds[name]
            entry: dict[str, Any] = {"labels": dict(labelkey)}
            if kind == "histogram":
                entry.update(inst.to_dict())
                entry.pop("counts", None)
                for q in (0.5, 0.95, 0.99):
                    entry[f"p{int(q * 100)}"] = inst.quantile(q)
            elif kind == "rate":
                entry["rate"] = inst.rate()
                entry["total"] = inst.total
            else:
                entry["value"] = inst.value
            out.setdefault(name, []).append(entry)
        return out

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold another registry's counters and histograms into this one
        (gauges/rates are point-in-time — last write wins, like
        ``Counters.merge`` folding worker shards)."""
        with other._lock:
            items = list(other._metrics.items())
            kinds = dict(other._kinds)
            helps = dict(other._help)
        for (name, labelkey), inst in items:
            kind = kinds[name]
            labels = dict(labelkey)
            if kind == "counter":
                self.counter(name, helps.get(name, ""), **labels).inc(
                    inst.value)
            elif kind == "histogram":
                mine = self.histogram(name, helps.get(name, ""),
                                      bounds=inst.bounds, **labels)
                mine.merge(inst)
            elif kind == "gauge":
                self.gauge(name, helps.get(name, ""), **labels).set(
                    inst.value)
            # rates cannot be meaningfully merged across processes

    # -- exposition ---------------------------------------------------------
    def render(self) -> str:
        """Prometheus text exposition (format version 0.0.4)."""
        with self._lock:
            items = sorted(self._metrics.items())
            kinds = dict(self._kinds)
            helps = dict(self._help)
        by_name: dict[str, list] = {}
        for (name, labelkey), inst in items:
            by_name.setdefault(name, []).append((dict(labelkey), inst))
        lines: list[str] = []
        for name in sorted(by_name):
            kind = kinds[name]
            exposed_type = "gauge" if kind == "rate" else kind
            if helps.get(name):
                lines.append(f"# HELP {name} {helps[name]}")
            lines.append(f"# TYPE {name} {exposed_type}")
            for labels, inst in by_name[name]:
                base = _label_str(labels)
                if kind == "histogram":
                    for le, cum in inst.cumulative_buckets():
                        lab = _label_str({**labels, "le": _fmt(le)})
                        lines.append(f"{name}_bucket{lab} {cum}")
                    lines.append(f"{name}_sum{base} {_fmt(inst.sum)}")
                    lines.append(f"{name}_count{base} {inst.count}")
                elif kind == "rate":
                    lines.append(f"{name}{base} {_fmt(inst.rate())}")
                else:
                    lines.append(f"{name}{base} {_fmt(inst.value)}")
        return "\n".join(lines) + "\n"


def _label_str(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


NULL_METRICS = MetricsRegistry(enabled=False)


# ---------------------------------------------------------------------------
# exposition parsing — the dashboard and the checker consume the scrape
# text itself, not process state
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})?'
    r'\s+(?P<value>[^\s]+)\s*$')
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape_label(v: str) -> str:
    return (v.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


def _parse_value(s: str) -> float:
    if s == "+Inf":
        return math.inf
    if s == "-Inf":
        return -math.inf
    if s == "NaN":
        return math.nan
    return float(s)


def parse_exposition(text: str) -> dict[str, dict]:
    """Parse Prometheus text exposition into::

        {family: {"type": str|None, "help": str|None,
                  "samples": [(sample_name, labels_dict, value)]}}

    ``_bucket``/``_sum``/``_count`` samples group under their histogram's
    family name.  Raises ValueError on a malformed line."""
    out: dict[str, dict] = {}
    declared: set[str] = set()

    def family(name: str) -> str:
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in declared:
                return name[:-len(suffix)]
        return name

    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line[len("# HELP "):].split(" ", 1)
            fam = out.setdefault(parts[0], {"type": None, "help": None,
                                            "samples": []})
            fam["help"] = parts[1] if len(parts) > 1 else ""
            declared.add(parts[0])
            continue
        if line.startswith("# TYPE "):
            parts = line[len("# TYPE "):].split(" ", 1)
            fam = out.setdefault(parts[0], {"type": None, "help": None,
                                            "samples": []})
            fam["type"] = parts[1].strip() if len(parts) > 1 else ""
            declared.add(parts[0])
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample: {line!r}")
        labels = {k: _unescape_label(v) for k, v in
                  _LABEL_PAIR_RE.findall(m.group("labels") or "")}
        value = _parse_value(m.group("value"))
        fam_name = family(m.group("name"))
        fam = out.setdefault(fam_name, {"type": None, "help": None,
                                        "samples": []})
        fam["samples"].append((m.group("name"), labels, value))
    return out


def quantile_from_buckets(buckets: list[tuple[float, float]],
                          q: float) -> float | None:
    """Nearest-rank quantile from scraped cumulative ``(le, count)``
    buckets — how ``metis-tpu top`` turns a /metrics scrape back into
    p50/p99 without process access.  None when the histogram is empty."""
    if not buckets:
        return None
    buckets = sorted(buckets, key=lambda b: b[0])
    total = buckets[-1][1]
    if total <= 0:
        return None
    target = max(1.0, math.ceil(q * total))
    prev_bound = None
    for le, cum in buckets:
        if cum >= target:
            if not math.isfinite(le):
                return prev_bound  # overflow bucket: best we can say
            if prev_bound and prev_bound > 0 and le > 0:
                return math.sqrt(prev_bound * le)
            return le
        prev_bound = le if math.isfinite(le) else prev_bound
    return prev_bound
