"""Planner daemon: long-lived plan service over local HTTP — the port of
``metis_tpu/serve/daemon.py``.  It runs on the host and holds no device:
the daemon, its search workers and the planner they run import no torch
(``tests/test_torch_imports.py``), so a daemon starts in the time of its
profile load, not of a torch import.

The offline CLI rebuilds everything per invocation — process, profiles,
estimator, memo tables.  :class:`PlanService` keeps all of it resident:

- **Plan cache** (:mod:`serve.cache`): responses keyed by
  ``obs.ledger.query_fingerprint`` (model × cluster × every cost-relevant
  SearchConfig field) + requested top_k, so a repeat query is a dict copy
  (<10 ms) instead of a search.  ``plan_request`` / ``plan_cache_hit`` /
  ``plan_cache_miss`` events per query.
- **Warm search state**: cold queries run through
  ``planner.api.plan_hetero`` with a retained
  ``make_search_state`` evaluator (estimator, balancer, stage grids,
  batched-costing tables), so repeat cold searches skip setup.  States
  are not reentrant, so one search runs at a time (``_search_lock``);
  concurrency comes from the cache, and identical concurrent misses
  coalesce single-flight behind one search.
- **Drift-driven replanning**: trainers POST ``accuracy_sample``s; the
  daemon owns the ``AccuracyMonitor``/``DriftDetector`` per plan
  fingerprint and, when an alarm fires, runs
  ``planner.replan.replan_on_drift`` in a background thread, invalidates
  the affected cache entries, re-caches the fresh plan, and pushes a
  ``replan_push`` notification that subscribed trainers collect via
  long-polled ``GET /notifications``.

Transport is stdlib-only: ``http.server.ThreadingHTTPServer`` on
localhost TCP or an ``AF_UNIX`` socket.  Responses are byte-identical to
the offline path — the ``plans`` field is the exact
``core.types.dump_ranked_plans`` rendering the CLI prints.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import socket
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path
from typing import Any
from urllib.parse import parse_qs, urlparse

from metis_tpu_torch.cluster.spec import ClusterSpec
from metis_tpu_torch.core.config import ModelSpec, SearchConfig
from metis_tpu_torch.core.errors import (
    MetisError,
    StandbyReadOnlyError,
    TenantSpecError,
)
from metis_tpu_torch.core.events import EventLog, NULL_LOG
from metis_tpu_torch.core.trace import Counters, Tracer
from metis_tpu_torch.core.types import dump_ranked_plans
from metis_tpu_torch.obs.ledger import (
    AccuracyLedger,
    AccuracyMonitor,
    calibration_fingerprint,
    fingerprint_ranked_plan,
    query_fingerprint,
)
from metis_tpu_torch.obs.provenance import (
    DecisionLog,
    artifact_digest,
    planner_decision_fields,
    profile_store_digest,
)
from metis_tpu_torch.inference.planner import (
    dump_inference_plans,
    fingerprint_inference_plan,
    plan_inference,
)
from metis_tpu_torch.inference.workload import InferenceWorkload, workload_from_dict
from metis_tpu_torch.obs.metrics import MetricsRegistry
from metis_tpu_torch.planner.api import make_search_state, plan_hetero
from metis_tpu_torch.planner.replan import (
    ClusterDelta,
    grow_cluster,
    replan_on_drift,
    shrink_cluster,
)
from metis_tpu_torch.profiles.store import ProfileStore
from metis_tpu_torch.sched.fleet import FleetPlan, FleetScheduler
from metis_tpu_torch.sched.tenant import TenantSpec, tenant_from_dict
from metis_tpu_torch.serve import persist
from metis_tpu_torch.serve.cache import PlanCache
from metis_tpu_torch.serve.pool import SearchPoolError, SearchWorkerPool


def model_spec_from_dict(d: dict) -> ModelSpec:
    """Rebuild a ModelSpec from its ``dataclasses.asdict`` JSON form."""
    return ModelSpec(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in d.items()})


def search_config_from_dict(d: dict) -> SearchConfig:
    """Rebuild a SearchConfig from JSON (lists back to tuples)."""
    return SearchConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in d.items()})


@dataclass
class _QueryRecord:
    """What the daemon remembers about a served query — enough to re-run
    it when its plan drifts, even after the cache entry is invalidated."""

    model: ModelSpec
    config: SearchConfig
    top_k: int | None
    key: str
    plan_fingerprint: str | None
    workload: InferenceWorkload | None = None  # None = training query
    # the served best's per-stage (tp, layer_start, layer_end) triples —
    # what migration pricing compares when a replan displaces this plan
    plan_layout: tuple | None = None
    # boot-topology node ids the served plans' placements touch — a
    # ClusterDelta invalidates exactly the cache entries whose set
    # intersects the changed nodes (None = unknown, always invalidated)
    node_id_set: frozenset | None = None
    # seq of the decision-log record that picked the served plan — the
    # causal parent every cache hit / drift replan for this query cites
    decision_seq: int | None = None


class PlanService:
    """Transport-agnostic daemon core; the HTTP layer is a thin shim so
    tests and the smoke tool can drive this in-process.

    ``state_dir`` turns on the durable control plane (``serve/persist``):
    a digest-verified snapshot of the daemon's logical state plus an
    append-only oplog of every mutation.  Boot restores the snapshot and
    replays the oplog tail, so a restarted daemon serves the identical
    plan cache (dumps, certificates, decision-seq continuity) its
    predecessor held — ``restore_s`` records how long that took.
    ``read_only=True`` makes this instance a standby: it applies
    replicated oplog entries (``serve/standby.py``) and answers read
    queries, but rejects every state-mutating request with
    :class:`StandbyReadOnlyError` (HTTP 503 + ``"standby": true``) until
    promoted."""

    # notification window: how many notes /notifications retains.  Ops
    # beyond the window stay in the oplog; the window's truncation
    # metadata (``oldest_seq``/``truncated``) tells a slow poller to
    # resync from ``GET /oplog`` instead of silently missing pushes.
    NOTES_WINDOW = 256
    # bounded in-memory op tail for /oplog when no state_dir is set
    OP_TAIL_WINDOW = 4096
    # how many applied delta ids the idempotency table remembers
    DELTA_DEDUP_WINDOW = 256

    def __init__(
        self,
        cluster: ClusterSpec,
        profiles: ProfileStore,
        *,
        cache_capacity: int = 128,
        cache_shards: int = 4,
        state_capacity: int = 8,
        search_pool: int = 0,
        events: EventLog = NULL_LOG,
        calibration=None,
        drift_band_pct: float = 20.0,
        drift_min_samples: int = 5,
        search_wait_s: float = 300.0,
        metrics: MetricsRegistry | None = None,
        decisions: DecisionLog | None = None,
        state_dir: str | Path | None = None,
        snapshot_interval: float = 30.0,
        read_only: bool = False,
    ):
        self.cluster = cluster
        # boot topology: the elastic ceiling scale-up deltas grow back toward
        # (planner.replan.grow_cluster needs the reference node order)
        self.full_cluster = cluster
        self.profiles = profiles
        self.events = events
        self.calibration = calibration
        self.drift_band_pct = drift_band_pct
        self.drift_min_samples = drift_min_samples
        self.search_wait_s = search_wait_s
        self.counters = Counters()
        # metrics=None builds a live registry (the daemon's /metrics
        # surface); pass obs.metrics.NULL_METRICS to measure the
        # uninstrumented baseline (bench telemetry section)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.cache = PlanCache(cache_capacity, counters=self.counters,
                               metrics=self.metrics, shards=cache_shards)
        self.state_capacity = state_capacity
        self.ledger = AccuracyLedger(None)  # in-memory: daemon-lifetime
        # decisions=None keeps the audit trail in memory (GET /decisions
        # still answers); pass DecisionLog(path) for a durable log whose
        # seq numbering survives restarts
        self.decisions = decisions if decisions is not None \
            else DecisionLog(None, events=self.events)
        # content digests stamped onto every decision record: which
        # calibration and profile store the choice was made against
        self._digests: dict[str, str] = {}
        cal_fp = calibration_fingerprint(calibration)
        if cal_fp:
            self._digests["calibration"] = cal_fp
        prof_fp = profile_store_digest(profiles)
        if prof_fp:
            self._digests["profiles"] = prof_fp
        # _lock: registry/state-table mutations.  _search_lock: serializes
        # searches (warm evaluators are not reentrant).  _accuracy_lock:
        # ledger + monitors.  Ordering: never take _lock while holding it
        # inside cache/_note locks; searches never hold _lock.
        self._lock = threading.Lock()
        self._search_lock = threading.Lock()
        self._accuracy_lock = threading.Lock()
        self._states: dict[str, Any] = {}  # query fp -> CandidateEvaluator
        self._state_order: list[str] = []
        self._inflight: dict[str, threading.Event] = {}
        self._queries: dict[str, _QueryRecord] = {}
        self._monitors: dict[str, AccuracyMonitor] = {}
        self._handled_alarms: dict[str, int] = {}
        self._notes: list[dict] = []
        # highest note seq ever dropped from the window — the truncation
        # watermark /notifications reports so a poller that fell behind
        # can detect the gap instead of silently missing pushes
        self._notes_dropped_high = 0
        self._note_seq = 0
        self._note_cond = threading.Condition()
        self._closed = False
        # multi-tenant mode: built lazily on the first tenant registration;
        # None = classic single-job daemon, behavior byte-identical to
        # before sched/ existed
        self.sched: FleetScheduler | None = None
        # -- durable control plane (serve/persist) --------------------------
        self.read_only = read_only
        self.snapshot_interval = float(snapshot_interval)
        # client-minted delta-id -> response: makes POST /cluster_delta
        # idempotent under the client's connection-error retries (a
        # replayed shrink must not double-apply)
        self._applied_deltas: OrderedDict[str, dict] = OrderedDict()
        # recent ops for GET /oplog when no durable oplog is configured
        self._op_tail: deque[dict] = deque(maxlen=self.OP_TAIL_WINDOW)
        # True while restore/standby replay applies entries: suppresses
        # fresh op logging for mutations that ARE replayed ops
        self._replaying = False
        self.restore_s: float | None = None
        self._snapshot_store: persist.SnapshotStore | None = None
        self._oplog: persist.Oplog | None = None
        self._last_snapshot_seq = 0
        self._snap_lock = threading.Lock()
        self._snap_stop = threading.Event()
        self._snap_thread: threading.Thread | None = None
        self.cache.on_invalidate = self._on_cache_invalidate
        # persistent cold-search worker pool (serve/pool.py): spawned once
        # here — BEFORE the snapshot thread exists, so fork-started
        # workers never inherit a live background thread — and fed
        # searches over queues for the daemon's lifetime.  0 = off (cold
        # misses serialize behind _search_lock exactly as before); a
        # standby never searches, so it never pays for a pool.
        self.search_pool: SearchWorkerPool | None = None
        if search_pool > 0 and not read_only:
            try:
                self.search_pool = SearchWorkerPool(
                    cluster, profiles, search_pool,
                    state_capacity=state_capacity, metrics=self.metrics)
            except SearchPoolError as e:
                self.counters.inc("serve.pool_boot_failed")
                self.events.emit("parallel_fallback",
                                 reason=f"search pool boot: {e}")
        if state_dir is not None:
            self._snapshot_store = persist.SnapshotStore(state_dir)
            self._oplog = persist.Oplog(
                Path(state_dir) / persist.OPLOG_FILE)
            self._boot_restore()
            if not read_only and self.snapshot_interval > 0:
                self._snap_thread = threading.Thread(
                    target=self._snapshot_loop,
                    name="metis-serve-snapshot", daemon=True)
                self._snap_thread.start()
        self._t_start = time.monotonic()

    # -- cache keys ---------------------------------------------------------
    @staticmethod
    def _cache_key(qfp: str, top_k: int | None) -> str:
        return f"{qfp}/k={top_k if top_k is not None else 'all'}"

    # -- node identity ------------------------------------------------------
    def _full_node_ids(self, cluster: ClusterSpec) -> tuple[int, ...]:
        """Map each node of ``cluster`` (a shrink of the boot topology) to
        its index in ``full_cluster`` — the stable id namespace every
        warm-state tag and query record uses.  Shrinks peel from the END
        of each type's node run (``planner.replan.shrink_cluster``) and
        grows rebuild toward the reference order, so the k-th surviving
        node of a type IS the k-th reference node of that type."""
        by_type: dict[str, list[int]] = {}
        for i, n in enumerate(self.full_cluster.nodes):
            by_type.setdefault(n.device_type, []).append(i)
        seen: dict[str, int] = {}
        ids: list[int] = []
        for n in cluster.nodes:
            k = seen.get(n.device_type, 0)
            ids.append(by_type[n.device_type][k])
            seen[n.device_type] = k + 1
        return tuple(ids)

    def _changed_node_ids(self, old_cluster: ClusterSpec,
                          new_cluster: ClusterSpec) -> frozenset:
        """Boot-topology ids of nodes a delta touched: present on one side
        only, or surviving with a different device count (partial loss
        narrows the last matching node rather than dropping it)."""
        old_w = {fid: n.num_devices for fid, n in
                 zip(self._full_node_ids(old_cluster), old_cluster.nodes)}
        new_w = {fid: n.num_devices for fid, n in
                 zip(self._full_node_ids(new_cluster), new_cluster.nodes)}
        return frozenset(fid for fid in old_w.keys() | new_w.keys()
                         if old_w.get(fid) != new_w.get(fid))

    # -- durable control plane ----------------------------------------------
    def _boot_restore(self) -> None:
        """Load the latest verified snapshot, then replay the oplog tail
        past its cursor — restart ≈ warm.  A corrupt primary snapshot
        falls back to ``.prev`` inside :class:`persist.SnapshotStore`;
        both generations corrupt raises (never serve partial state).
        ``restore_s`` is measured here, around exactly the state work —
        process relaunch cost (interpreter + jax imports) is the host's
        problem, not the control plane's."""
        t0 = time.perf_counter()
        doc = self._snapshot_store.load()
        entries = 0
        self._replaying = True
        try:
            if doc is not None:
                persist.restore_state(self, doc["payload"])
            for entry in self._oplog.entries(since=self._note_seq):
                persist.apply_entry(self, entry)
                entries += 1
        finally:
            self._replaying = False
        self._last_snapshot_seq = (
            int(doc["payload"].get("op_seq", 0)) if doc is not None else 0)
        self.restore_s = round(time.perf_counter() - t0, 6)
        if doc is not None or entries:
            self.events.emit(
                "snapshot_restore", seq=self._note_seq, entries=entries,
                source=(doc.get("source") if doc is not None else "oplog"))

    def snapshot_now(self) -> dict | None:
        """Capture + atomically persist the full logical state; returns
        the written snapshot's meta (None when persistence is off or
        this is a standby).  Called by the periodic loop, synchronously
        after tenant/cluster mutations (keeping replay tails short), and
        once more on :meth:`close`."""
        if self._snapshot_store is None or self.read_only:
            return None
        with self._snap_lock:
            payload = persist.capture_state(self)
            meta = self._snapshot_store.write(payload)
            self._last_snapshot_seq = payload["op_seq"]
        self.events.emit(
            "snapshot_write", seq=payload["op_seq"],
            entries=len(payload["cache"]), bytes=meta["bytes"])
        self.counters.inc("serve.snapshots")
        return meta

    def _snapshot_loop(self) -> None:
        while not self._snap_stop.wait(self.snapshot_interval):
            with self._note_cond:
                dirty = self._note_seq != self._last_snapshot_seq
            if not dirty:
                continue
            try:
                self.snapshot_now()
            except Exception:
                # a failed periodic snapshot must never kill the daemon;
                # the age gauge going stale is the operator's signal
                self.counters.inc("serve.snapshot_errors")

    def _check_writable(self, what: str) -> None:
        if self.read_only:
            raise StandbyReadOnlyError(
                f"standby daemon is read-only: {what} must go to the "
                "primary (or wait for promotion)")

    def _append_op(self, op: str, note: dict | None = None,
                   **data) -> tuple[dict, dict | None]:
        """Append one state-mutation op to the unified sequence — THE
        mutation record.  Op seqs are dense (every mutation takes exactly
        one); notes are the subset of ops that carry a notification, so
        note seqs are sparse within the op namespace.  The entry lands in
        the in-memory tail (for ``GET /oplog``) and, when a state_dir is
        configured, in the durable oplog before this returns."""
        with self._note_cond:
            self._note_seq += 1
            seq = self._note_seq
            ts = time.time()
            entry = {"seq": seq, "ts": ts, "op": op, **data}
            if note is not None:
                note = {"seq": seq, "ts": ts, **note}
                entry["note"] = note
                self._notes.append(note)
                if len(self._notes) > self.NOTES_WINDOW:
                    dropped = self._notes[:-self.NOTES_WINDOW]
                    self._notes_dropped_high = max(
                        self._notes_dropped_high, dropped[-1]["seq"])
                    del self._notes[:-self.NOTES_WINDOW]
            self._op_tail.append(entry)
            self._note_cond.notify_all()
        if self._oplog is not None:
            self._oplog.append(entry)
        self.metrics.counter("metis_oplog_appends_total").inc()
        self.events.emit("oplog_append", seq=seq, op=op)
        return entry, note

    def _on_cache_invalidate(self, key: str) -> None:
        """PlanCache invalidation hook: one ``plan_invalidate`` op per
        dropped entry, whichever path (drift alarm, cluster delta,
        operator ``/invalidate``) dropped it — suppressed while restore/
        standby replay is itself applying logged ops."""
        if self._replaying:
            return
        self._append_op("plan_invalidate", key=key)

    def _log_plan_insert(self, key: str, entry: dict) -> None:
        """One ``plan_insert`` op per cache fill, carrying the full
        response payload (plans, certificate, decision_seq) plus the
        serialized query record — everything a standby or a restore
        replay needs to reproduce the entry byte-identically."""
        if self._replaying:
            return
        with self._lock:
            rec = self._queries.get(key)
        self._append_op(
            "plan_insert", key=key, entry=entry,
            query=persist.query_record_to_dict(rec)
            if rec is not None else None)

    def _cluster_state_dict(self) -> dict:
        """Current topology as an absolute delta from the boot topology —
        what cluster-affecting ops carry so replay is idempotent."""
        delta = ClusterDelta.between(self.full_cluster, self.cluster)
        return {"removed": delta.removed, "added": delta.added}

    def oplog_window(self, since: int = 0) -> dict:
        """Ops with ``seq > since`` for ``GET /oplog`` — from the durable
        oplog when one is configured, else the bounded in-memory tail.
        Op seqs are dense, so ``truncated`` is exact: the reader has a
        gap iff ops between its cursor and the oldest held seq are gone
        (resync path: re-bootstrap from the snapshot)."""
        if self._oplog is not None:
            entries = self._oplog.entries(since=since)
            oldest = self._oplog.first_seq
        else:
            with self._note_cond:
                held = list(self._op_tail)
            entries = [e for e in held if e["seq"] > since]
            oldest = held[0]["seq"] if held else None
        with self._note_cond:
            last = self._note_seq
        return {
            "entries": entries,
            "last_seq": last,
            "oldest_seq": oldest,
            "truncated": oldest is not None and since < oldest - 1,
        }

    # -- warm search state --------------------------------------------------
    def _state_for(self, qfp: str, model: ModelSpec, config: SearchConfig):
        """Warm evaluator for this query shape, building (and LRU-bounding)
        on demand.  Caller must hold ``_search_lock``."""
        with self._lock:
            state = self._states.get(qfp)
            if state is not None:
                self._state_order.remove(qfp)
                self._state_order.append(qfp)
                return state
        state = make_search_state(self.cluster, self.profiles, model,
                                  config, counters=self.counters,
                                  node_ids=self._full_node_ids(self.cluster))
        with self._lock:
            self._states[qfp] = state
            self._state_order.append(qfp)
            while len(self._state_order) > self.state_capacity:
                evicted = self._state_order.pop(0)
                self._states.pop(evicted, None)
                self.counters.inc("serve.state_evict")
        return state

    # -- plan queries -------------------------------------------------------
    def plan_query(self, model: ModelSpec, config: SearchConfig,
                   top_k: int | None = None,
                   workload: InferenceWorkload | None = None,
                   trace_id: str | None = None) -> dict:
        """Answer one plan query: cache hit, coalesced wait, or cold
        search with warm state.  Byte-identical to the offline path.

        ``workload`` switches the query to the serving planner
        (``inference.planner.plan_inference``); the fingerprint hashes the
        workload kind + SLO fields, so training and inference queries for
        the same model/cluster never share a cache entry.  ``trace_id``
        (client-minted) stamps every event, span, and worker heartbeat
        this query causes — the handle ``metis-tpu report --trace``
        reconstructs one request's span tree from."""
        return self._plan_query(model, config, top_k=top_k,
                                workload=workload, trace_id=trace_id,
                                encoded=False)

    def plan_query_encoded(self, model: ModelSpec, config: SearchConfig,
                           top_k: int | None = None,
                           workload: InferenceWorkload | None = None,
                           trace_id: str | None = None) -> bytes:
        """:meth:`plan_query` returning the final serialized UTF-8
        response body — the HTTP hot path.  A cache hit splices the
        request tail (``cached``/``serve_ms``/``trace_id``) onto the
        pre-encoded entry bytes the cache stored at ``put`` time, so the
        per-hit cost is a byte concatenation, not a ``json.dumps`` of a
        multi-kilobyte plan dump.  The bytes are identical to
        ``json.dumps(plan_query(...))`` by construction (asserted in
        tests/test_torch_serve.py)."""
        return self._plan_query(model, config, top_k=top_k,
                                workload=workload, trace_id=trace_id,
                                encoded=True)

    def _plan_query(self, model: ModelSpec, config: SearchConfig,
                    top_k: int | None = None,
                    workload: InferenceWorkload | None = None,
                    trace_id: str | None = None,
                    encoded: bool = False):
        t_req = time.perf_counter()
        qfp = query_fingerprint(model, self.cluster, config,
                                calibration=self.calibration,
                                workload=workload)
        key = self._cache_key(qfp, top_k)
        self.counters.inc("serve.requests")
        ev = (self.events.with_fields(trace_id=trace_id)
              if trace_id else self.events)
        tracer = Tracer(ev)
        kind = "inference" if workload is not None else "training"
        with tracer.span("serve_request", fingerprint=qfp,
                         model=model.name, gbs=config.gbs) as span:
            ev.emit("plan_request", fingerprint=qfp,
                    model=model.name, gbs=config.gbs, top_k=top_k,
                    workload=kind)
            hit = self.cache.get_with_body(key)
            if hit is not None:
                entry, body = hit
                ev.emit("plan_cache_hit", fingerprint=qfp)
                span.set(cached=True)
                # one cheap append: the hit's causal parent is the search
                # decision that filled the entry (bench pins this path's
                # overhead ≤ 2%, so no confidence/digest work here)
                self.decisions.record(
                    "cache_hit",
                    plan_fingerprint=entry.get("plan_fingerprint") or "",
                    query_fingerprint=qfp, trace_id=trace_id,
                    parent_seq=entry.get("decision_seq"),
                    total_ms=entry.get("best_cost_ms"))
                return self._finish(entry, body, cached=True, t_req=t_req,
                                    trace_id=trace_id, encoded=encoded)
            ev.emit("plan_cache_miss", fingerprint=qfp)
            span.set(cached=False)
            # a standby serves replicated cache hits but never searches —
            # its state must stay a pure function of the primary's oplog
            self._check_writable("plan search (cache miss)")
            # single-flight: identical concurrent misses wait for the
            # leader's search to land in the cache instead of repeating it
            waited_since = None
            while True:
                with self._lock:
                    waiter = self._inflight.get(key)
                    if waiter is None:
                        self._inflight[key] = threading.Event()
                        break
                if waited_since is None:
                    waited_since = time.perf_counter()
                    self.metrics.counter(
                        "metis_serve_coalesced_waits_total").inc()
                waiter.wait(timeout=self.search_wait_s)
                hit = self.cache.get_with_body(key)
                if hit is not None:
                    entry, body = hit
                    self.metrics.histogram(
                        "metis_serve_coalesced_wait_ms").observe(
                        (time.perf_counter() - waited_since) * 1000)
                    self.decisions.record(
                        "cache_hit",
                        plan_fingerprint=entry.get("plan_fingerprint")
                        or "",
                        query_fingerprint=qfp, trace_id=trace_id,
                        parent_seq=entry.get("decision_seq"),
                        total_ms=entry.get("best_cost_ms"),
                        detail={"coalesced": True})
                    return self._finish(entry, body, cached=True,
                                        t_req=t_req, trace_id=trace_id,
                                        encoded=encoded)
                # leader failed or timed out — loop to become the leader
            try:
                if workload is not None:
                    entry = self._search_inference(qfp, key, model, config,
                                                   workload, top_k,
                                                   events=ev,
                                                   trace_id=trace_id)
                else:
                    entry = self._search(qfp, key, model, config, top_k,
                                         events=ev, trace_id=trace_id)
            finally:
                with self._lock:
                    done = self._inflight.pop(key, None)
                if done is not None:
                    done.set()
            return self._finish(entry, None, cached=False, t_req=t_req,
                                trace_id=trace_id, encoded=encoded)

    def _risk_posture(self, config: SearchConfig,
                      residual_model) -> dict:
        """Risk-posture annotation for a search's decision record: was
        the served ranking point-ranked, quantile/CVaR-ranked (with the
        parameter), or built on transferred profiles?  Empty dict for a
        plain point-ranked, fully-profiled search — decision records
        stay byte-identical for those.  Also refreshes the
        ``metis_transfer_scale_factor`` gauge per transferred type."""
        posture: dict = {}
        q = getattr(config, "risk_quantile", 0.0)
        a = getattr(config, "cvar_alpha", 0.0)
        if residual_model is not None and (q or a):
            if a:
                posture.update(ranking="cvar", cvar_alpha=a)
            else:
                posture.update(ranking="quantile", risk_quantile=q)
        elif q or a:
            # knobs asked for but the ledger was too thin to fit
            posture.update(ranking="point", risk_requested=True)
        transferred = getattr(self.profiles, "transferred", None)
        if transferred:
            posture["transferred_profiles"] = sorted(transferred)
            for target, prov in transferred.items():
                scale = prov.get("time_scale")
                if scale is not None:
                    self.metrics.gauge(
                        "metis_transfer_scale_factor",
                        target_type=target).set(scale)
        return posture

    def _search(self, qfp: str, key: str, model: ModelSpec,
                config: SearchConfig, top_k: int | None,
                events: EventLog | None = None,
                trace_id: str | None = None,
                decision_kind: str = "cold_search",
                parent_seq: int | None = None, cause: str = "",
                tenant: str | None = None) -> dict:
        ev = events if events is not None else self.events
        queue_depth = self.metrics.gauge("metis_serve_queue_depth")
        queue_depth.inc()
        # risk-aware queries (risk_quantile/cvar_alpha, or an exact-
        # backend query wanting a confidence-p certificate): fit the
        # residual model from the live accuracy ledger ONCE per search
        # (emits residual_fit); stays None — point mode, byte-identical
        # — when the knobs are off and the backend is beam, or when the
        # ledger is too thin to fit
        residual_model = None
        risk_active = bool(getattr(config, "risk_quantile", 0.0)
                           or getattr(config, "cvar_alpha", 0.0))
        if risk_active or getattr(config, "backend", "beam") == "exact":
            from metis_tpu_torch.cost.uncertainty import fit_residual_model

            with self._accuracy_lock:
                residual_model = fit_residual_model(self.ledger, events=ev)
        try:
            result = None
            pool = self.search_pool
            if (pool is not None and getattr(config, "backend",
                                             "beam") != "exact"
                    and not (risk_active and residual_model is not None)):
                # (risk-ranked searches take the serial path — the pool
                # workers don't carry the ledger-fit residual model)
                # resident worker pool: index-stride shards across warm
                # processes, byte-identical ranking (serve/pool.py), and
                # the daemon thread never holds _search_lock for the
                # search itself.  Exact-backend queries stay serial — the
                # certificate comes from the branch-and-bound search.
                result = self._pool_search(pool, qfp, model, config,
                                           top_k, ev)
            if result is None:
                with self._search_lock:
                    t0 = time.perf_counter()
                    # warm state only helps the serial path; workers>1
                    # queries go through search/parallel.py's own
                    # per-worker shards
                    state = (self._state_for(qfp, model, config)
                             if config.workers == 1 else None)
                    result = plan_hetero(self.cluster, self.profiles,
                                         model, config, top_k=top_k,
                                         events=ev, search_state=state,
                                         metrics=self.metrics,
                                         residual_model=residual_model)
                    self.metrics.histogram(
                        "metis_search_duration_seconds",
                        kind="training").observe(time.perf_counter() - t0)
        finally:
            queue_depth.dec()
        best = result.best
        plan_fp = fingerprint_ranked_plan(best) if best is not None else None
        entry = {
            "fingerprint": qfp,
            "plan_fingerprint": plan_fp,
            "top_k": top_k,
            "plans": dump_ranked_plans(result.plans),
            "best_cost_ms": best.cost.total_ms if best else None,
            "num_costed": result.num_costed,
            "num_pruned": result.num_pruned,
            "num_bound_pruned": result.num_bound_pruned,
            "search_seconds": round(result.search_seconds, 6),
        }
        if result.certificate is not None:
            # exact-backend cold search: the optimality certificate rides
            # the /plan response (and the cached entry) verbatim
            entry["certificate"] = result.certificate.to_json_dict()
            if result.certificate.confidence_p is not None:
                self.metrics.gauge("metis_plan_confidence_p").set(
                    result.certificate.confidence_p)
        # provenance: one decision record per search — runner-up/margin,
        # breakdown, certificate (planner_decision_fields), content
        # digests, and the ledger's per-component residual stats as the
        # model-confidence context for the margin
        with self._accuracy_lock:
            confidence = self.ledger.component_residuals() or None
        fields = planner_decision_fields(result)
        fields.pop("plan_fingerprint", None)
        dec = self.decisions.record(
            decision_kind, plan_fingerprint=plan_fp or "",
            query_fingerprint=qfp, trace_id=trace_id,
            parent_seq=parent_seq, cause=cause, tenant=tenant,
            confidence=confidence,
            digests={**self._digests,
                     "config": artifact_digest(
                         dataclasses.asdict(config))},
            detail={"cache_key": key, "num_costed": result.num_costed,
                    "search_seconds": entry["search_seconds"],
                    **self._risk_posture(config, residual_model)},
            **fields)
        entry["decision_seq"] = dec.seq
        with self._lock:
            self._queries[key] = _QueryRecord(
                model=model, config=config, top_k=top_k, key=key,
                plan_fingerprint=plan_fp,
                plan_layout=self._best_layout(best),
                node_id_set=frozenset(self._full_node_ids(self.cluster)),
                decision_seq=dec.seq)
        if best is not None and plan_fp is not None:
            with self._accuracy_lock:
                if plan_fp not in self.ledger.predictions:
                    # component-resolved prediction: the breakdown's
                    # additive shares feed the per-component residual
                    # analytics once measurements arrive
                    self.ledger.record_prediction(
                        plan_fp, best.cost.total_ms,
                        components=(best.breakdown.components
                                    if best.breakdown is not None
                                    else None),
                        source="serve",
                        device_type="+".join(self.cluster.device_types))
        self.cache.put(key, entry)
        self._log_plan_insert(key, entry)
        return entry

    def _pool_search(self, pool: SearchWorkerPool, qfp: str,
                     model: ModelSpec, config: SearchConfig,
                     top_k: int | None, ev: EventLog):
        """Run one training search on the resident worker pool; returns a
        ``PlannerResult`` identical to the serial path's, or None to fall
        back (worker death, timeout, unpicklable inputs).

        The search itself runs lock-free in the pool; only the short
        explain pass (breakdowns for the top-k, via the parent's warm
        state) takes ``_search_lock``.  The workers' ``touched_nodes`` /
        ``tagged_candidates`` merge into the parent state so
        ``apply_cluster_delta``'s incremental keep/drop pivot still sees
        which fleet nodes this query's candidates priced against."""
        from metis_tpu_torch.planner.api import DEFAULT_EXPLAIN_K, PlannerResult
        t0 = time.perf_counter()
        try:
            out = pool.search(qfp, self.cluster, model, config, top_k,
                              self._full_node_ids(self.cluster), events=ev)
        except SearchPoolError as e:
            self.counters.inc("serve.pool_fallback")
            ev.emit("parallel_fallback", reason=f"search pool: {e}")
            return None
        self.counters.inc("serve.pool_search")
        if out.warm:
            self.counters.inc("serve.pool_warm_hit")
        if out.counters:
            self.counters.merge(out.counters)
        results = list(out.plans)
        explain_k = min(len(results),
                        top_k if top_k is not None else DEFAULT_EXPLAIN_K)
        with self._search_lock:
            state = self._state_for(qfp, model, config)
            state.touched_nodes |= set(out.touched_nodes)
            state.tagged_candidates = max(state.tagged_candidates,
                                          out.tagged_candidates)
            for i in range(explain_k):
                rp = results[i]
                try:
                    _, bd = state.estimator.get_breakdown(
                        rp.inter, rp.intra.strategies,
                        rp.intra.layer_partition,
                        schedule=rp.intra.schedule,
                        virtual_stages=rp.intra.virtual_stages)
                except KeyError:  # pragma: no cover - costed once already
                    continue
                results[i] = dataclasses.replace(rp, breakdown=bd)
                ev.emit(
                    "plan_explain", rank=i + 1,
                    fingerprint=fingerprint_ranked_plan(rp),
                    total_ms=round(bd.total_ms, 4),
                    components={k: round(v, 4)
                                for k, v in bd.components.items()},
                    schedule=rp.intra.schedule)
        elapsed = time.perf_counter() - t0
        self.metrics.histogram(
            "metis_search_duration_seconds",
            kind="training").observe(elapsed)
        ev.emit(
            "search_finished", mode="hetero", num_costed=out.num_costed,
            num_pruned=out.num_pruned, seconds=round(elapsed, 4),
            best_cost_ms=(results[0].cost.total_ms if results else None),
            num_bound_pruned=out.num_bound_pruned,
            workers=pool.num_workers)
        return PlannerResult(
            plans=tuple(results), num_costed=out.num_costed,
            num_pruned=out.num_pruned,
            search_seconds=out.search_seconds,
            num_bound_pruned=out.num_bound_pruned)

    def _search_inference(self, qfp: str, key: str, model: ModelSpec,
                          config: SearchConfig,
                          workload: InferenceWorkload,
                          top_k: int | None,
                          events: EventLog | None = None,
                          trace_id: str | None = None,
                          decision_kind: str = "cold_search",
                          parent_seq: int | None = None,
                          cause: str = "",
                          tenant: str | None = None) -> dict:
        """Cold inference search.  No warm state — the pool search is
        orders of magnitude smaller than a training search — but it still
        serializes behind ``_search_lock`` so the cluster it reads cannot
        be swapped mid-enumeration by a concurrent ``cluster_delta``."""
        ev = events if events is not None else self.events
        queue_depth = self.metrics.gauge("metis_serve_queue_depth")
        queue_depth.inc()
        try:
            with self._search_lock:
                t0 = time.perf_counter()
                result = plan_inference(
                    self.cluster, self.profiles, model, config, workload,
                    top_k=top_k if top_k is not None else 20, events=ev)
                elapsed = time.perf_counter() - t0
                self.metrics.histogram(
                    "metis_search_duration_seconds",
                    kind="inference").observe(elapsed)
        finally:
            queue_depth.dec()
        best = result.best
        plan_fp = fingerprint_inference_plan(best) if best else None
        entry = {
            "fingerprint": qfp,
            "plan_fingerprint": plan_fp,
            "workload_kind": "inference",
            "top_k": top_k,
            "plans": dump_inference_plans(result, workload),
            "best_ttft_p99_ms": best.cost.ttft_p99_ms if best else None,
            "best_tpot_p99_ms": best.cost.tpot_p99_ms if best else None,
            "best_max_rps": best.cost.throughput_rps if best else None,
            "slo_ok": best.cost.slo_ok if best else None,
            "num_costed": result.num_costed,
            "num_pruned": result.num_pruned,
            "search_seconds": round(elapsed, 6),
        }
        dec = self.decisions.record(
            decision_kind, plan_fingerprint=plan_fp or "",
            query_fingerprint=qfp, trace_id=trace_id,
            parent_seq=parent_seq, cause=cause, tenant=tenant,
            digests={**self._digests,
                     "config": artifact_digest(
                         dataclasses.asdict(config))},
            detail={"cache_key": key, "workload_kind": "inference",
                    "num_costed": result.num_costed,
                    "search_seconds": entry["search_seconds"]})
        entry["decision_seq"] = dec.seq
        with self._lock:
            self._queries[key] = _QueryRecord(
                model=model, config=config, top_k=top_k, key=key,
                plan_fingerprint=plan_fp, workload=workload,
                node_id_set=frozenset(self._full_node_ids(self.cluster)),
                decision_seq=dec.seq)
        self.cache.put(key, entry)
        self._log_plan_insert(key, entry)
        return entry

    @staticmethod
    def _best_layout(best) -> tuple | None:
        """Per-stage ``(tp, layer_start, layer_end)`` triples of a ranked
        plan — the canonical layout key migration pricing compares
        (``execution/reshard.py``); None when the plan records no usable
        partition."""
        if best is None:
            return None
        try:
            bounds = list(best.intra.layer_partition)
            return tuple(
                (int(s.tp), int(bounds[i]), int(bounds[i + 1]))
                for i, s in enumerate(best.intra.strategies))
        except (AttributeError, IndexError, TypeError):
            return None

    def _migration_cost_ms(self, model: ModelSpec, old_layout,
                           new_layout) -> float | None:
        """One-time live-transfer estimate for switching a running job
        between two served plans — the same moved-bytes rule the cost
        model's additive ``migration`` term amortizes, un-amortized so
        subscribers can weigh it against their measured checkpoint-restore
        time.  None when either side's layout is unknown."""
        if not old_layout or not new_layout:
            return None
        from metis_tpu_torch.cost.migration import price_migration_ms
        from metis_tpu_torch.cost.volume import TransformerVolume

        volume = TransformerVolume(
            model, self.profiles.model.params_per_layer_bytes)
        return round(price_migration_ms(old_layout, new_layout, volume), 6)

    @staticmethod
    def _respond(entry: dict, *, cached: bool, t_req: float,
                 trace_id: str | None = None) -> dict:
        out = dict(entry)
        out["cached"] = cached
        out["serve_ms"] = round((time.perf_counter() - t_req) * 1000, 3)
        if trace_id is not None:
            # echo the client-minted id so the caller can hand it straight
            # to `metis-tpu report --trace`
            out["trace_id"] = trace_id
        return out

    @classmethod
    def _finish(cls, entry: dict, body: bytes | None, *, cached: bool,
                t_req: float, trace_id: str | None,
                encoded: bool):
        """Render the response: a dict (classic API) or the final UTF-8
        body bytes (HTTP hot path).  The encoded hit path splices the
        per-request tail onto the cache's pre-encoded entry bytes —
        ``json.dumps(entry)[:-1] + ", " + json.dumps(tail)[1:]`` is
        byte-identical to ``json.dumps({**entry, **tail})`` under the
        default separators, because the tail keys (``cached``,
        ``serve_ms``, ``trace_id``) never occur in a cache entry and
        ``dict`` preserves insertion order."""
        if not encoded:
            return cls._respond(entry, cached=cached, t_req=t_req,
                                trace_id=trace_id)
        if body is None or len(body) < 3:
            # no pre-encoded form (fresh search, or an unserializable
            # payload): one dumps, exactly what the handler used to pay
            return json.dumps(cls._respond(
                entry, cached=cached, t_req=t_req,
                trace_id=trace_id)).encode("utf-8")
        tail: dict[str, Any] = {
            "cached": cached,
            "serve_ms": round((time.perf_counter() - t_req) * 1000, 3),
        }
        if trace_id is not None:
            tail["trace_id"] = trace_id
        return body[:-1] + b", " + json.dumps(tail).encode("utf-8")[1:]

    # -- accuracy + drift ---------------------------------------------------
    def post_accuracy_sample(self, fingerprint: str, measured_ms: float,
                             step: int | None = None,
                             stage_ms=(), predicted_ms=None,
                             trace_id: str | None = None) -> dict:
        """Feed one measured step for a served plan; on a drift alarm a
        background thread replans every query whose cached best is that
        plan and pushes ``replan_push`` notifications."""
        self._check_writable("accuracy sample")
        self.counters.inc("serve.accuracy_samples")
        with self._accuracy_lock:
            if (predicted_ms is not None
                    and fingerprint not in self.ledger.predictions):
                self.ledger.record_prediction(
                    fingerprint, float(predicted_ms), source="serve")
            monitor = self._monitors.get(fingerprint)
            if monitor is None:
                monitor = AccuracyMonitor(
                    self.ledger, fingerprint, events=self.events,
                    band_pct=self.drift_band_pct,
                    min_samples=self.drift_min_samples,
                    skip_steps=0, source="serve")
                self._monitors[fingerprint] = monitor
            monitor.observe(float(measured_ms), step=step,
                            stage_ms=tuple(stage_ms))
            status = monitor.status()
            handled = self._handled_alarms.get(fingerprint, 0)
            fire = status.alarms > handled
            if fire:
                self._handled_alarms[fingerprint] = status.alarms
        if fire:
            self.counters.inc("serve.drift_replans")
            # bind the triggering sample's trace_id onto everything the
            # background replan emits — the thread outlives this request,
            # but the telemetry stays attributable to it
            ev = (self.events.with_fields(trace_id=trace_id)
                  if trace_id else self.events)
            threading.Thread(
                target=self._replan_for,
                args=(fingerprint, status, ev, trace_id),
                name="metis-serve-replan", daemon=True).start()
        return {
            "fingerprint": fingerprint,
            "in_drift": status.in_drift,
            "rolling_mape_pct": status.rolling_mape_pct,
            "n": status.n,
            "alarms": status.alarms,
            "replanning": fire,
        }

    def _replan_for(self, plan_fp: str, status,
                    events: EventLog | None = None,
                    trace_id: str | None = None) -> list[dict]:
        """Drift-alarm fallout: re-search every registered query whose
        best plan is ``plan_fp``, refresh the cache, notify trainers."""
        ev = events if events is not None else self.events
        with self._lock:
            targets = [rec for rec in self._queries.values()
                       if rec.plan_fingerprint == plan_fp]
        # the drifting plan's own per-component residuals are the
        # evidence the alarm fired on — they ride the drift decision as
        # its confidence context
        with self._accuracy_lock:
            drift_conf = self.ledger.component_residuals(
                fingerprint=plan_fp) or None
        notes: list[dict] = []
        for rec in targets:
            self.cache.invalidate(rec.key)
            # re-key against the CURRENT topology — after a cluster delta
            # the same (model, config) maps to a different fingerprint
            qfp = query_fingerprint(rec.model, self.cluster, rec.config,
                                    calibration=self.calibration)
            new_key = self._cache_key(qfp, rec.top_k)
            with self._search_lock:
                state = (self._state_for(qfp, rec.model, rec.config)
                         if rec.config.workers == 1 else None)
                report = replan_on_drift(
                    status, self.cluster, self.profiles, rec.model,
                    rec.config, top_k=rec.top_k, events=ev,
                    search_state=state)
            if report is None or report.result.best is None:
                continue
            best = report.result.best
            new_fp = fingerprint_ranked_plan(best)
            entry = {
                "fingerprint": qfp,
                "plan_fingerprint": new_fp,
                "top_k": rec.top_k,
                "plans": dump_ranked_plans(report.result.plans),
                "best_cost_ms": best.cost.total_ms,
                "num_costed": report.result.num_costed,
                "num_pruned": report.result.num_pruned,
                "num_bound_pruned": report.result.num_bound_pruned,
                "search_seconds": round(report.result.search_seconds, 6),
            }
            changed = bool(report.plan_changed) and new_fp != plan_fp
            fields = planner_decision_fields(report.result)
            fields.pop("plan_fingerprint", None)
            dec = self.decisions.record(
                "drift_replan", plan_fingerprint=new_fp or "",
                query_fingerprint=qfp, trace_id=trace_id,
                parent_seq=rec.decision_seq, cause="drift_alarm",
                confidence=drift_conf,
                digests=dict(self._digests),
                detail={"old_fingerprint": plan_fp,
                        "plan_changed": changed,
                        "rolling_mape_pct": getattr(
                            status, "rolling_mape_pct", None)},
                **fields)
            entry["decision_seq"] = dec.seq
            self.cache.put(new_key, entry)
            with self._lock:
                self._queries.pop(rec.key, None)
                self._queries[new_key] = _QueryRecord(
                    model=rec.model, config=rec.config, top_k=rec.top_k,
                    key=new_key, plan_fingerprint=new_fp,
                    decision_seq=dec.seq)
            self._log_plan_insert(new_key, entry)
            with self._accuracy_lock:
                if new_fp not in self.ledger.predictions:
                    self.ledger.record_prediction(
                        new_fp, best.cost.total_ms,
                        components=(best.breakdown.components
                                    if best.breakdown is not None
                                    else None),
                        source="serve",
                        device_type="+".join(self.cluster.device_types))
            note = self._push_note({
                "kind": "replan_push",
                "fingerprint": plan_fp,
                "new_fingerprint": new_fp,
                "query_fingerprint": qfp,
                "plan_changed": changed,
                "new_best_cost_ms": best.cost.total_ms,
                "reason": "drift_alarm",
                "decision_seq": dec.seq,
            })
            ev.emit(
                "replan_push", fingerprint=plan_fp, new_fingerprint=new_fp,
                reason="drift_alarm", plan_changed=changed,
                seq=note["seq"], decision_seq=dec.seq)
            notes.append(note)
        return notes

    # -- topology change ----------------------------------------------------
    def apply_cluster_delta(self, removed: dict[str, int] | None = None,
                            added: dict[str, int] | None = None,
                            replan: bool = False,
                            trace_id: str | None = None,
                            cause: str | None = None,
                            delta_id: str | None = None) -> dict:
        """Elastic topology change: lose ``removed`` devices and/or restore
        ``added`` (type -> count, capped by the boot topology).  Swaps in
        the new cluster, drops every cache entry and warm state, notifies
        subscribers; ``replan=True`` additionally re-searches every
        registered query against the new topology on a background thread,
        pushing one ``replan_push`` note per refreshed plan (the elastic
        scale path the traffic-replay bench exercises).  A no-op delta
        (nothing changed, e.g. a remove cancelled by an add in the same
        call) keeps the cache and warm states and pushes nothing.

        ``delta_id`` makes the call idempotent end-to-end: deltas are
        RELATIVE (applying the same shrink twice removes twice the
        devices), so a client retry after a lost response would corrupt
        the topology.  A client-minted id is checked against a bounded
        window of applied ids and a duplicate returns the original
        response (flagged ``deduplicated``) without touching anything."""
        self._check_writable("cluster delta")
        if delta_id is not None:
            with self._lock:
                hit = self._applied_deltas.get(delta_id)
            if hit is not None:
                self.counters.inc("serve.delta_dedup")
                resp = dict(hit)
                resp["deduplicated"] = True
                return resp
        removed = {str(t): int(n) for t, n in (removed or {}).items()}
        added = {str(t): int(n) for t, n in (added or {}).items()}
        ev = (self.events.with_fields(trace_id=trace_id)
              if trace_id else self.events)
        with self._search_lock:
            new_cluster = self.cluster
            if removed:
                new_cluster = shrink_cluster(new_cluster, removed)
            if added:
                new_cluster = grow_cluster(new_cluster, self.full_cluster,
                                           added)
            delta = ClusterDelta.between(self.cluster, new_cluster)
            if delta.is_empty:
                # nothing actually changed (e.g. a remove cancelled by an
                # add in the same call): keep the plan cache and the warm
                # search states — an empty delta must be cheap — and push
                # nothing, so subscribers never see a phantom topology
                # change
                with self._note_cond:
                    seq = self._note_seq
                return {"invalidated": 0, "removed": {}, "added": {},
                        "devices": new_cluster.total_devices, "seq": seq,
                        "replanning": False}
            # which boot-topology nodes this delta actually touches —
            # the incremental-replan keep/drop pivot for warm states and
            # record-tagged cache entries alike
            changed = self._changed_node_ids(self.cluster, new_cluster)
            # the provenance ROOT of everything this delta causes: the
            # fleet re-partition, every tenant displacement, and every
            # background delta-replan chain back to this seq.  The kind
            # distinguishes an autoscaler's delta from an operator's.
            root_kind = ("autoscale_delta"
                         if (cause or "").startswith("autoscale")
                         else "cluster_delta")
            root_dec = self.decisions.record(
                root_kind, trace_id=trace_id, cause=cause or "",
                detail={"removed": delta.removed, "added": delta.added,
                        "devices": new_cluster.total_devices,
                        "changed_nodes": sorted(changed)})
            with self._lock:
                pre_states = list(self._states.keys())
            # multi-tenant mode: re-partition the fleet FIRST (it raises
            # FleetOverCommitError before mutating anything when the
            # survivors cannot cover the quota floors, so a rejected
            # shrink leaves daemon and scheduler state untouched), then
            # swap the daemon topology in lockstep
            old_fleet = fleet_plan = None
            fleet_decisions: dict[str, dict] = {}
            if self.sched is not None and len(self.sched.registry):
                old_fleet = self.sched.last_plan
                fleet_plan, fleet_decisions = self.sched.apply_delta(
                    removed=delta.removed, added=delta.added,
                    decision_cause=cause or "",
                    decision_parent=root_dec.seq)
            # incremental replanning: keep every warm state whose tagged
            # node set misses the changed nodes — its costed candidates
            # stay bit-valid (fingerprint-keyed states can never serve a
            # stale topology; at worst they idle until their carve
            # recurs).  Only states that existed BEFORE the fleet
            # re-partition are judged: states the re-partition itself
            # just built are already on the new topology.
            reused = recosted = kept = dropped = 0
            with self._lock:
                self.cluster = new_cluster
                for qfp in pre_states:
                    state = self._states.get(qfp)
                    if state is None:
                        continue  # LRU-evicted during the re-partition
                    if state.touched_nodes & changed:
                        self._states.pop(qfp, None)
                        if qfp in self._state_order:
                            self._state_order.remove(qfp)
                        recosted += state.tagged_candidates
                        dropped += 1
                    else:
                        reused += state.tagged_candidates
                        kept += 1
            self.counters.inc("replan.incremental.reused", reused)
            self.counters.inc("replan.incremental.recosted", recosted)
            # cache entries whose recorded node set misses the changed
            # nodes stay valid for the topology they were answered on
            # (their keys re-materialize on an exact round-trip delta);
            # untagged entries are invalidated conservatively
            with self._lock:
                keep_keys = {
                    rec.key for rec in self._queries.values()
                    if rec.node_id_set is not None
                    and not (rec.node_id_set & changed)}
            if fleet_plan is not None:
                # tenant-scoped invalidation: tenant entries survive
                # unless their carve moved; non-tenant entries go through
                # the record-tag filter
                invalidated = len(self.cache.invalidate_where(
                    lambda k, v: v.get("tenant") is None
                    and k not in keep_keys))
                invalidated += len(self._invalidate_changed_tenants(
                    old_fleet, fleet_plan))
            else:
                invalidated = len(self.cache.invalidate_where(
                    lambda k, _v: k not in keep_keys))
            ev.emit(
                "incremental_replan",
                changed_nodes=sorted(changed),
                states_kept=kept, states_dropped=dropped,
                reused=reused, recosted=recosted,
                invalidated=invalidated)
        # the oplog op carries the ABSOLUTE post-delta topology (delta
        # from the boot topology) and the full post-partition fleet, so a
        # replica replaying it lands on this exact state no matter how
        # many times the entry is applied
        _op, note = self._append_op(
            "cluster_delta",
            note={
                "kind": "cluster_delta",
                "removed": delta.removed,
                "added": delta.added,
                "invalidated": invalidated,
                "devices": new_cluster.total_devices,
                "decision_seq": root_dec.seq,
            },
            cluster=self._cluster_state_dict(),
            delta_id=delta_id,
            fleet=(self.sched.export_state()
                   if fleet_plan is not None else None))
        for name in sorted(fleet_decisions):
            d = fleet_decisions[name]
            if d.get("preempted"):
                self._push_note({
                    "kind": "tenant_preempt", "tenant": name,
                    "from_devices": d["from_devices"],
                    "to_devices": d["to_devices"],
                })
            self._push_note({
                "kind": "tenant_replan", "tenant": name,
                "devices": d["devices"], "path": d.get("path"),
                "migration_ms": d.get("migration_ms"),
                "feasible": d.get("feasible"),
                "decision_seq": d.get("decision_seq"),
            })
        if replan:
            self.counters.inc("serve.delta_replans")
            threading.Thread(
                target=self._replan_all,
                args=("cluster_delta", ev, trace_id, root_dec.seq,
                      cause or ""),
                name="metis-serve-delta-replan", daemon=True).start()
        resp = {"invalidated": invalidated, "removed": delta.removed,
                "added": delta.added,
                "devices": new_cluster.total_devices, "seq": note["seq"],
                "replanning": replan,
                "decision_seq": root_dec.seq,
                "tenants_changed": sorted(fleet_decisions)}
        if delta_id is not None:
            with self._lock:
                self._applied_deltas[delta_id] = dict(resp)
                while len(self._applied_deltas) > self.DELTA_DEDUP_WINDOW:
                    self._applied_deltas.popitem(last=False)
        # force a snapshot: topology changes are rare and expensive to
        # lose, and it shrinks the window in which a replica's dedup map
        # holds the oplog's stub response instead of the full one
        self.snapshot_now()
        return resp

    def _replan_all(self, reason: str,
                    events: EventLog | None = None,
                    trace_id: str | None = None,
                    parent_seq: int | None = None,
                    cause: str = "") -> list[dict]:
        """Re-search every registered query against the CURRENT topology
        and push a ``replan_push`` note per query — the cluster-delta
        counterpart of the drift path's ``_replan_for``.  Each re-search
        records a ``delta_replan`` decision parented on the triggering
        delta's seq, completing the causal chain from capacity event to
        pushed plan."""
        ev = events if events is not None else self.events
        with self._lock:
            targets = list(self._queries.values())
        notes: list[dict] = []
        for rec in targets:
            self.cache.invalidate(rec.key)
            qfp = query_fingerprint(rec.model, self.cluster, rec.config,
                                    calibration=self.calibration,
                                    workload=rec.workload)
            new_key = self._cache_key(qfp, rec.top_k)
            try:
                if rec.workload is not None:
                    entry = self._search_inference(
                        qfp, new_key, rec.model, rec.config, rec.workload,
                        rec.top_k, events=ev, trace_id=trace_id,
                        decision_kind="delta_replan",
                        parent_seq=parent_seq, cause=cause or reason)
                else:
                    entry = self._search(qfp, new_key, rec.model,
                                         rec.config, rec.top_k, events=ev,
                                         trace_id=trace_id,
                                         decision_kind="delta_replan",
                                         parent_seq=parent_seq,
                                         cause=cause or reason)
            except MetisError:
                # the shrunken topology may not fit this query at all —
                # subscribers learn from the absence of a push
                continue
            with self._lock:
                if rec.key != new_key:
                    self._queries.pop(rec.key, None)
            new_fp = entry.get("plan_fingerprint")
            changed = new_fp != rec.plan_fingerprint
            with self._lock:
                nrec = self._queries.get(new_key)
            new_layout = nrec.plan_layout if nrec is not None else None
            mig = self._migration_cost_ms(rec.model, rec.plan_layout,
                                          new_layout)
            payload = {
                "kind": "replan_push",
                "fingerprint": rec.plan_fingerprint,
                "new_fingerprint": new_fp,
                "query_fingerprint": qfp,
                "plan_changed": changed,
                "new_best_cost_ms": entry.get("best_cost_ms"),
                "reason": reason,
                "decision_seq": entry.get("decision_seq"),
            }
            if mig is not None:
                # one-time cost of resharding the old plan's live state
                # onto the new plan, for subscribers weighing live
                # migration against checkpoint-restore
                payload["migration_cost_ms"] = mig
            note = self._push_note(payload)
            ev.emit(
                "replan_push", fingerprint=rec.plan_fingerprint,
                new_fingerprint=new_fp, reason=reason,
                plan_changed=changed, migration_cost_ms=mig,
                seq=note["seq"], decision_seq=entry.get("decision_seq"))
            notes.append(note)
        return notes

    def invalidate(self, fingerprint: str | None = None,
                   drop_states: bool = False) -> dict:
        """Drop cache entries (all, or those for one query fingerprint);
        warm states survive unless ``drop_states`` — the knob bench uses
        to separate warm-state from cold-process search cost."""
        self._check_writable("cache invalidation")
        if fingerprint is None:
            n = self.cache.invalidate_all()
        else:
            n = len(self.cache.invalidate_where(
                lambda _k, v: v.get("fingerprint") == fingerprint))
        if drop_states:
            with self._lock:
                self._states.clear()
                self._state_order.clear()
        return {"invalidated": n}

    # -- multi-tenant scheduling --------------------------------------------
    def _tenant_search_state(self, spec, cluster, sub, node_indices):
        """Warm-state provider the fleet scheduler calls per training
        search: retain one evaluator per (tenant, carve fingerprint),
        tagged with the carve's boot-topology node ids so
        ``apply_cluster_delta`` keeps it warm whenever the delta misses
        the carve.  ``cluster`` is whatever topology the scheduler carved
        ``node_indices`` from — the current fleet, or the reference
        topology for the admission baseline (the daemon's own cluster may
        lag the scheduler's mid-delta).  Runs under ``_search_lock``
        (every scheduler invocation holds it), so the reuse is
        race-free."""
        if spec.workload is not None or spec.config.workers != 1:
            return None  # inference searches carry no warm state
        qfp = query_fingerprint(spec.model, sub, spec.config,
                                calibration=self.calibration)
        key = f"tenant/{spec.name}/{qfp}"
        with self._lock:
            state = self._states.get(key)
            if state is not None:
                self._state_order.remove(key)
                self._state_order.append(key)
                return state
        fleet_ids = self._full_node_ids(cluster)
        store = self.sched._stores.get(spec.name, self.profiles) \
            if self.sched is not None else self.profiles
        state = make_search_state(
            sub, store, spec.model, spec.config, counters=self.counters,
            node_ids=tuple(fleet_ids[i] for i in node_indices))
        with self._lock:
            self._states[key] = state
            self._state_order.append(key)
            while len(self._state_order) > self.state_capacity:
                evicted = self._state_order.pop(0)
                self._states.pop(evicted, None)
                self.counters.inc("serve.state_evict")
        return state

    def _ensure_sched(self) -> FleetScheduler:
        with self._lock:
            if self.sched is None:
                sched = FleetScheduler(
                    self.full_cluster, self.profiles, events=self.events,
                    search_state_provider=self._tenant_search_state,
                    metrics=self.metrics, decisions=self.decisions)
                sched.cluster = self.cluster  # may already be shrunk
                self.sched = sched
            return self.sched

    def _invalidate_changed_tenants(self, old_plan: FleetPlan | None,
                                    new_plan: FleetPlan) -> list[str]:
        """Tenant-scoped cache invalidation: drop exactly the entries of
        tenants whose carve or ranked plans moved between two fleet plans
        (plus tenants that vanished) — everyone else's cached answers
        stay warm."""
        changed = []
        for a in new_plan.allocations:
            old = old_plan.allocation(a.tenant) if old_plan else None
            if old is None or old.node_indices != a.node_indices \
                    or old.plan_json != a.plan_json:
                changed.append(a.tenant)
        if old_plan is not None:
            for a in old_plan.allocations:
                if new_plan.allocation(a.tenant) is None:
                    changed.append(a.tenant)
        if changed:
            gone = set(changed)
            self.cache.invalidate_where(
                lambda _k, v: v.get("tenant") in gone)
        return changed

    def tenant_register(self, spec: TenantSpec) -> dict:
        """Admit a tenant into the fleet (building the scheduler on first
        use), re-partition, and push a ``tenant_admit`` note.  Admission
        failures (bad spec, floors past capacity) raise typed errors the
        HTTP layer maps to 400 without mutating fleet state.

        Re-registering a byte-identical spec is idempotent: the client
        retries POSTs on connection errors, so a register whose response
        was dropped must not 400 on the retry — it answers from the
        current fleet plan without re-partitioning.  A *different* spec
        under the same name still raises (that is a conflict, not a
        retry)."""
        self._check_writable("tenant register")
        sched = self._ensure_sched()
        with self._search_lock:
            if spec.name in sched.registry \
                    and sched.registry.get(spec.name) == spec:
                plan = sched.last_plan or sched.schedule()
                alloc = plan.allocation(spec.name)
                with self._note_cond:
                    seq = self._note_seq
                return {
                    "tenant": spec.name,
                    "kind": spec.kind,
                    "devices": alloc.devices if alloc else 0,
                    "feasible": bool(alloc and alloc.feasible),
                    "utilization_frac": plan.utilization_frac,
                    "objective": plan.objective,
                    "tenants_changed": [],
                    "seq": seq,
                }
            old_plan = sched.last_plan
            sched.admit(spec)
            try:
                plan = sched.schedule(decision_cause="tenant_admit")
            except Exception:
                # admission is atomic: node granularity can defeat a
                # floor the admit-time pre-check accepted, and a 400
                # must not leave the tenant registered (every later
                # schedule/delta would keep failing on it)
                sched.remove(spec.name)
                raise
        changed = self._invalidate_changed_tenants(old_plan, plan)
        alloc = plan.allocation(spec.name)
        _op, note = self._append_op(
            "tenant_register",
            note={
                "kind": "tenant_admit",
                "tenant": spec.name,
                "priority": spec.priority,
                "devices": alloc.devices if alloc else 0,
                "feasible": bool(alloc and alloc.feasible),
            },
            cluster=self._cluster_state_dict(),
            fleet=sched.export_state())
        self.counters.inc("serve.tenants_admitted")
        self.snapshot_now()
        return {
            "tenant": spec.name,
            "kind": spec.kind,
            "devices": alloc.devices if alloc else 0,
            "feasible": bool(alloc and alloc.feasible),
            "utilization_frac": plan.utilization_frac,
            "objective": plan.objective,
            "tenants_changed": changed,
            "seq": note["seq"],
        }

    def tenant_remove(self, name: str) -> dict:
        self._check_writable("tenant remove")
        sched = self.sched
        if sched is None:
            raise TenantSpecError(f"no such tenant: {name!r}")
        with self._search_lock:
            old_plan = sched.last_plan
            sched.remove(name)
            plan = sched.schedule(decision_cause="tenant_remove")
        changed = self._invalidate_changed_tenants(old_plan, plan)
        gone = {name}
        self.cache.invalidate_where(lambda _k, v: v.get("tenant") in gone)
        _op, note = self._append_op(
            "tenant_remove",
            note={"kind": "tenant_remove", "tenant": name},
            cluster=self._cluster_state_dict(),
            fleet=sched.export_state())
        self.snapshot_now()
        return {"tenant": name, "tenants_changed": changed,
                "seq": note["seq"]}

    def tenant_plan(self, name: str, trace_id: str | None = None) -> dict:
        """Per-tenant query routing: serve the tenant's slice of the
        current fleet plan.  The ``plans`` field is the planner dump the
        fleet scheduler produced on the tenant's sub-cluster — for a
        single registered tenant that is byte-identical to a direct
        ``/plan`` answer on the whole cluster.  Cached under a
        tenant-tagged key so a cluster delta only evicts the tenants it
        actually moved."""
        t_req = time.perf_counter()
        sched = self.sched
        if sched is None:
            raise TenantSpecError(f"no such tenant: {name!r}")
        spec = sched.registry.get(name)
        with self._search_lock:
            plan = sched.last_plan or sched.schedule()
            alloc = plan.allocation(name)
            node_ix = alloc.node_indices if alloc else ()
            sub = (sched.cluster.subset(node_ix) if node_ix
                   else sched.cluster)
        qfp = query_fingerprint(spec.model, sub, spec.config,
                                calibration=self.calibration,
                                workload=spec.workload)
        # the key names the actual carve: an empty/missing allocation
        # fingerprints against the whole cluster above, and without the
        # carve marker that key would collide with a full-cluster grant
        carve = ",".join(map(str, node_ix)) if node_ix else "empty"
        key = f"tenant/{name}/{carve}/{qfp}"
        self.counters.inc("serve.requests")
        ev = (self.events.with_fields(trace_id=trace_id)
              if trace_id else self.events)
        ev.emit("plan_request", fingerprint=qfp,
                model=spec.model.name, gbs=spec.config.gbs,
                top_k=None, workload=spec.kind, tenant=name)
        entry = self.cache.get(key)
        if entry is not None:
            ev.emit("plan_cache_hit", fingerprint=qfp)
            self.decisions.record(
                "cache_hit",
                plan_fingerprint=entry.get("plan_fingerprint") or "",
                query_fingerprint=qfp, trace_id=trace_id,
                parent_seq=entry.get("decision_seq"), tenant=name)
            return self._respond(entry, cached=True, t_req=t_req,
                                 trace_id=trace_id)
        ev.emit("plan_cache_miss", fingerprint=qfp)
        # the plan being served was chosen by the fleet scheduler, not by
        # this request: point the cache entry at the tenant's latest
        # provenance record (its tenant_replan after a delta, or the
        # admitting fleet_repartition) so tenant cache hits chain into
        # the same causal tree
        tdec = self.decisions.find(tenant=name)
        plan_fp = ""
        if alloc is not None:
            plan_fp = FleetScheduler._alloc_fingerprint(alloc)
        entry = {
            "fingerprint": qfp,
            "plan_fingerprint": plan_fp or None,
            "tenant": name,
            "kind": spec.kind,
            "devices": alloc.devices if alloc else 0,
            "node_indices": list(alloc.node_indices) if alloc else [],
            "feasible": bool(alloc and alloc.feasible),
            "plans": alloc.plan_json if alloc else None,
            "utility": round(alloc.utility, 9) if alloc else 0.0,
            "utility_frac": round(alloc.utility_frac, 9) if alloc else 0.0,
            "decision_seq": (tdec.seq if tdec is not None
                             else sched.last_decision_seq),
        }
        if not self.read_only:
            # a standby serves the computed entry without caching it:
            # inserting locally would mint state the primary's oplog never
            # saw, and the entry is cheap to recompute from the replicated
            # fleet plan anyway
            self.cache.put(key, entry)
            self._log_plan_insert(key, entry)
        return self._respond(entry, cached=False, t_req=t_req,
                             trace_id=trace_id)

    def tenant_status(self, name: str | None = None) -> dict:
        sched = self.sched
        if sched is None:
            if name is not None:
                raise TenantSpecError(f"no such tenant: {name!r}")
            return {"tenants": [], "objective": 0.0,
                    "utilization_frac": 0.0}
        with self._search_lock:
            plan = sched.last_plan or sched.schedule()
        if name is not None:
            sched.registry.get(name)  # typed error for unknown names
            alloc = plan.allocation(name)
            return alloc.to_json_dict() if alloc else {"tenant": name}
        return {
            "tenants": list(sched.registry.names()),
            "objective": round(plan.objective, 9),
            "utilization_frac": round(plan.utilization_frac, 9),
            "cluster_devices": plan.cluster_devices,
            "allocations": [
                {"tenant": a.tenant, "kind": a.kind,
                 "priority": a.priority, "devices": a.devices,
                 "reserved_devices": a.reserved_devices,
                 "spot_devices": a.spot_devices,
                 "feasible": a.feasible,
                 "utility_frac": round(a.utility_frac, 9)}
                for a in plan.allocations],
        }

    # -- notifications ------------------------------------------------------
    def _push_note(self, note: dict) -> dict:
        """Pure notification (replan_push, tenant_preempt, tenant_replan):
        an op whose only payload is the note itself — it rides the oplog
        like every other mutation so a standby replays the subscriber
        stream too."""
        _op, note = self._append_op("note", note=note)
        return note

    def notifications(self, since: int = 0,
                      timeout_s: float = 0.0) -> list[dict]:
        """Notes with seq > ``since``; blocks up to ``timeout_s`` for the
        first new one (long-poll).  A :meth:`close` (daemon shutdown)
        wakes every blocked poller immediately — it returns whatever is
        already pending instead of holding the socket until timeout."""
        return self.notifications_window(since=since,
                                         timeout_s=timeout_s)["notifications"]

    def notifications_window(self, since: int = 0,
                             timeout_s: float = 0.0) -> dict:
        """:meth:`notifications` plus the metadata a client needs to
        DETECT a gap instead of silently missing notes: ``oldest_seq``
        (the oldest note still buffered, None when empty) and
        ``truncated`` — True when notes with seq > ``since`` have already
        been dropped from the bounded backlog, in which case the client's
        move is a full resync (or an ``/oplog?since=`` replay), not a
        catch-up from this response."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        with self._note_cond:
            while True:
                out = [n for n in self._notes if n["seq"] > since]
                remaining = deadline - time.monotonic()
                if out or remaining <= 0 or self._closed:
                    return {
                        "notifications": out,
                        "last_seq": self._note_seq,
                        "oldest_seq": (self._notes[0]["seq"]
                                       if self._notes else None),
                        "truncated": since < self._notes_dropped_high,
                    }
                self._note_cond.wait(remaining)

    def close(self) -> None:
        """Mark the service as shutting down and wake every long-polled
        :meth:`notifications` reader.  Idempotent; the HTTP servers call
        it from ``shutdown()`` before joining the serve loop, so no
        handler thread is left blocked on ``_note_cond`` holding a socket
        open past the daemon's death."""
        with self._note_cond:
            self._closed = True
            self._note_cond.notify_all()
        # stop the periodic snapshotter, then take one final snapshot so
        # a clean shutdown restores with zero oplog replay
        self._snap_stop.set()
        if self._snap_thread is not None:
            self._snap_thread.join(timeout=5.0)
            self._snap_thread = None
        try:
            self.snapshot_now()
        except Exception:  # pragma: no cover - best-effort on shutdown
            self.counters.inc("serve.snapshot_errors")
        if self.search_pool is not None:
            self.search_pool.close()
        if self._oplog is not None:
            self._oplog.close()
        # flush + release the durable decision-log handle; a restarted
        # daemon re-opens it and resumes the seq where this one stopped
        self.decisions.close()

    # -- introspection ------------------------------------------------------
    def healthz(self) -> dict:
        """Liveness + readiness.  Live = not shut down.  Ready = live and
        every check passes: no search currently holds the lock (a stuck
        search would starve cold queries), the plan cache holds at least
        one answer (a cold daemon serves its first query at search speed,
        not cache speed), and the last fleet plan — when multi-tenant mode
        is on — left every tenant feasible.  /healthz answers 200 when
        ready, 503 otherwise, so a load balancer can drain a daemon that
        is alive but not yet (or no longer) fit to serve."""
        live = not self._closed
        fleet_ok = True
        sched = self.sched
        if sched is not None and sched.last_plan is not None:
            fleet_ok = all(a.feasible for a in sched.last_plan.allocations)
        checks = {
            "search_lock_free": not self._search_lock.locked(),
            "cache_warm": len(self.cache) > 0,
            "fleet_feasible": fleet_ok,
        }
        return {
            "live": live,
            "ready": live and all(checks.values()),
            "checks": checks,
            "standby": self.read_only,
            "uptime_s": round(time.monotonic() - self._t_start, 3),
        }

    def render_metrics(self) -> str:
        """Prometheus text exposition of the whole registry, refreshing
        the derived gauges (ratios, occupancy, uptime) at scrape time —
        the cheap pull-model alternative to updating them on every
        request."""
        m = self.metrics
        counters = self.counters.as_dict()
        hits = counters.get("serve.cache.hit", 0)
        misses = counters.get("serve.cache.miss", 0)
        if hits + misses:
            m.gauge("metis_serve_cache_hit_ratio").set(
                hits / (hits + misses))
        m.gauge("metis_serve_cache_entries").set(len(self.cache))
        m.gauge("metis_serve_cache_capacity").set(self.cache.capacity)
        with self._lock:
            m.gauge("metis_serve_warm_states").set(len(self._states))
        with self._note_cond:
            m.gauge("metis_serve_notes_backlog").set(len(self._notes))
        m.gauge("metis_serve_uptime_seconds").set(
            time.monotonic() - self._t_start)
        m.gauge("metis_serve_tenants").set(
            len(self.sched.registry) if self.sched else 0)
        if self._snapshot_store is not None \
                and self._snapshot_store.last_ts is not None:
            m.gauge("metis_snapshot_age_seconds").set(
                max(0.0, time.time() - self._snapshot_store.last_ts))
            m.gauge("metis_snapshot_size_bytes").set(
                self._snapshot_store.last_bytes or 0)
        return m.render()

    def stats(self) -> dict:
        return {
            "uptime_s": round(time.monotonic() - self._t_start, 3),
            "cluster_devices": self.cluster.total_devices,
            "device_types": list(self.cluster.device_types),
            "cache": self.cache.stats(),
            "counters": self.counters.as_dict(),
            "warm_states": len(self._states),
            "search_pool_workers": (self.search_pool.num_workers
                                    if self.search_pool is not None else 0),
            "monitors": len(self._monitors),
            "queries": len(self._queries),
            "note_seq": self._note_seq,
            "decisions": len(self.decisions),
            "decision_seq": self.decisions.last_seq,
            "tenants": len(self.sched.registry) if self.sched else 0,
            "read_only": self.read_only,
            "state_dir": (str(self._snapshot_store.path.parent)
                          if self._snapshot_store is not None else None),
            "last_snapshot_seq": self._last_snapshot_seq,
            "restore_s": self.restore_s,
        }


# ---------------------------------------------------------------------------
# HTTP transport (stdlib http.server; TCP or AF_UNIX)
# ---------------------------------------------------------------------------


# endpoints that get their own label on the per-endpoint metrics;
# anything else (404s, typos) lands under "other" so an attacker probing
# paths cannot mint unbounded label cardinality
_KNOWN_ENDPOINTS = {
    "/plan", "/tenant", "/tenant_remove", "/accuracy_sample",
    "/cluster_delta", "/invalidate", "/shutdown",
    "/stats", "/healthz", "/metrics", "/notifications", "/decisions",
    "/oplog",
}


class _Handler(BaseHTTPRequestHandler):
    server_version = "metis-serve/1"
    # HTTP/1.1 => persistent connections by default.  Safe because every
    # response path below goes through _send, which always sets an exact
    # Content-Length (no chunked framing, no implicit close).  A client
    # that pools its socket skips the TCP+accept handshake per request —
    # the single biggest fixed cost on the cached-hit path.
    protocol_version = "HTTP/1.1"
    # idle keep-alive bound: StreamRequestHandler puts this on the socket,
    # and handle_one_request turns a timed-out wait-for-next-request into
    # close_connection, so an abandoned client frees its handler thread
    # instead of parking it forever
    timeout = 30.0
    # buffer the whole response and flush once per request
    # (handle_one_request's trailing flush): headers + body leave in ONE
    # segment.  Unbuffered writes on a reused connection trip Nagle +
    # delayed-ACK — the body segment waits ~40ms for the peer's ACK of
    # the header segment, which would swamp a ~1ms cached hit.
    wbufsize = -1

    def setup(self) -> None:
        super().setup()
        try:
            self.connection.setsockopt(socket.IPPROTO_TCP,
                                       socket.TCP_NODELAY, True)
        except OSError:  # AF_UNIX has no Nagle to disable
            pass

    # quiet by default (the daemon's story is the events JSONL, not stderr)
    def log_message(self, format: str, *args: Any) -> None:
        pass

    def address_string(self) -> str:
        # AF_UNIX peers have no (host, port); BaseHTTPRequestHandler's
        # default unpack would crash on the empty client_address
        addr = self.client_address
        return addr[0] if isinstance(addr, tuple) and addr else "unix"

    @property
    def service(self) -> PlanService:
        return self.server.service  # type: ignore[attr-defined]

    def _send(self, code: int, body: bytes,
              content_type: str = "application/json") -> None:
        """Single response-writing chokepoint: exact Content-Length
        always, and an HONEST ``Connection`` header — when the worker
        pool has a backlog, the connection is closed after this response
        (and says so) so a stalled client cannot park a pooled thread
        while accepted-but-unserved sockets wait in the queue."""
        self._status = code
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        if not self.close_connection:
            backlog = getattr(self.server, "pool_backlog_size", None)
            if backlog is not None and backlog() > 0:
                self.close_connection = True
        if self.close_connection:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, payload: dict) -> None:
        self._send(code, json.dumps(payload).encode())

    def _raw_json(self, code: int, body: bytes) -> None:
        """Pre-encoded JSON straight to the socket — the zero-copy leg of
        the cached /plan hit (PlanService.plan_query_encoded)."""
        self._send(code, body)

    def _text(self, code: int, text: str,
              content_type: str = "text/plain; version=0.0.4; "
                                  "charset=utf-8") -> None:
        self._send(code, text.encode(), content_type)

    def _body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        if not length:
            return {}
        data = self.rfile.read(length)
        loaded = json.loads(data)
        if not isinstance(loaded, dict):
            raise ValueError("request body must be a JSON object")
        return loaded

    def _instrumented(self, inner) -> None:
        """Per-endpoint SLIs, recorded at the single point every request
        passes through so ``metis_serve_requests_total{endpoint=e}`` and
        the latency histogram's count reconcile exactly by construction."""
        m = self.service.metrics
        path = urlparse(self.path).path
        endpoint = (path.lstrip("/") if path in _KNOWN_ENDPOINTS
                    else "other")
        self._status = 200
        # handler instances persist for the lifetime of one connection,
        # so a per-instance request count measures keep-alive reuse
        self._reqs_on_conn = getattr(self, "_reqs_on_conn", 0) + 1
        if self._reqs_on_conn > 1:
            m.counter("metis_serve_keepalive_reuse_total").inc()
        m.gauge("metis_serve_inflight_requests").inc()
        t0 = time.perf_counter()
        try:
            inner()
        finally:
            dur_ms = (time.perf_counter() - t0) * 1000
            m.gauge("metis_serve_inflight_requests").dec()
            m.counter("metis_serve_requests_total",
                      endpoint=endpoint).inc()
            m.histogram("metis_serve_request_latency_ms",
                        endpoint=endpoint).observe(dur_ms)
            m.rate("metis_serve_qps").mark()
            if self._status >= 400:
                m.counter("metis_serve_errors_total",
                          endpoint=endpoint).inc()

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        self._instrumented(self._do_get)

    def do_POST(self) -> None:  # noqa: N802 (http.server API)
        self._instrumented(self._do_post)

    def _get_event(self, endpoint: str, trace_id: str | None) -> None:
        """One ``get_request`` event per monitoring GET, stamped with the
        caller's trace_id (query parameter) when given — the read-side
        counterpart of the POST paths' event trail, so a trace shows what
        the operator *looked at*, not only what the daemon did."""
        ev = (self.service.events.with_fields(trace_id=trace_id)
              if trace_id else self.service.events)
        ev.emit("get_request", endpoint=endpoint)

    def _do_get(self) -> None:
        parsed = urlparse(self.path)
        q = parse_qs(parsed.query)
        trace_id = q.get("trace_id", [None])[0]
        if parsed.path == "/stats":
            self._json(200, self.service.stats())
        elif parsed.path == "/healthz":
            health = self.service.healthz()
            self._json(200 if health["ready"] else 503, health)
        elif parsed.path == "/metrics":
            self._text(200, self.service.render_metrics())
        elif parsed.path == "/notifications":
            since = int(q.get("since", ["0"])[0])
            timeout_s = float(q.get("timeout", ["0"])[0])
            self._get_event(parsed.path, trace_id)
            self._json(200, self.service.notifications_window(
                since=since, timeout_s=timeout_s))
        elif parsed.path == "/oplog":
            since = int(q.get("since", ["0"])[0])
            self._get_event(parsed.path, trace_id)
            self._json(200, self.service.oplog_window(since=since))
        elif parsed.path == "/decisions":
            since = int(q.get("since", ["0"])[0])
            self._get_event(parsed.path, trace_id)
            recs = self.service.decisions.records(since=since)
            self._json(200, {
                "decisions": [r.to_json_dict() for r in recs],
                "last_seq": self.service.decisions.last_seq})
        elif parsed.path == "/tenant":
            name = q.get("name", [None])[0]
            self._get_event(parsed.path, trace_id)
            try:
                self._json(200, self.service.tenant_status(name=name))
            except MetisError as e:
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
        else:
            self._json(404, {"error": f"no such endpoint: {parsed.path}"})

    def _do_post(self) -> None:
        try:
            body = self._body()
            trace_id = body.get("trace_id")
            trace_id = str(trace_id) if trace_id is not None else None
            if self.path == "/plan":
                tenant = body.get("tenant")
                if tenant is not None:
                    # tenant routing: model/config/workload come from the
                    # registered TenantSpec, not the request body
                    self._json(200, self.service.tenant_plan(
                        str(tenant), trace_id=trace_id))
                    return
                model = model_spec_from_dict(body["model"])
                config = search_config_from_dict(body["config"])
                # top-level risk knobs: a client can ask for a tail-
                # quantile/CVaR-ranked answer without rebuilding its
                # config dict.  They land in the SearchConfig, which is
                # fingerprint-significant — so each (query, quantile)
                # pair caches independently (per-quantile caching).
                rq, ca = body.get("risk_quantile"), body.get("cvar_alpha")
                if rq is not None or ca is not None:
                    config = dataclasses.replace(
                        config,
                        risk_quantile=float(rq) if rq is not None else 0.0,
                        cvar_alpha=float(ca) if ca is not None else 0.0)
                top_k = body.get("top_k")
                wl = body.get("workload")
                out = self.service.plan_query_encoded(
                    model, config,
                    top_k=int(top_k) if top_k is not None else None,
                    workload=workload_from_dict(wl) if wl else None,
                    trace_id=trace_id)
                self._raw_json(200, out)
            elif self.path == "/tenant":
                out = self.service.tenant_register(tenant_from_dict(body))
                self._json(200, out)
            elif self.path == "/tenant_remove":
                out = self.service.tenant_remove(str(body["name"]))
                self._json(200, out)
            elif self.path == "/accuracy_sample":
                out = self.service.post_accuracy_sample(
                    str(body["fingerprint"]), float(body["measured_ms"]),
                    step=body.get("step"),
                    stage_ms=body.get("stage_ms", ()),
                    predicted_ms=body.get("predicted_ms"),
                    trace_id=trace_id)
                self._json(200, out)
            elif self.path == "/cluster_delta":
                cause = body.get("cause")
                delta_id = body.get("delta_id")
                out = self.service.apply_cluster_delta(
                    removed=body.get("removed"),
                    added=body.get("added"),
                    replan=bool(body.get("replan", False)),
                    trace_id=trace_id,
                    cause=str(cause) if cause is not None else None,
                    delta_id=(str(delta_id) if delta_id is not None
                              else None))
                self._json(200, out)
            elif self.path == "/invalidate":
                out = self.service.invalidate(
                    fingerprint=body.get("fingerprint"),
                    drop_states=bool(body.get("drop_states", False)))
                self._json(200, out)
            elif self.path == "/shutdown":
                self._json(200, {"ok": True})
                # shutdown() must run off the handler thread — it joins
                # the serve_forever loop that is waiting on this handler
                threading.Thread(target=self.server.shutdown,
                                 daemon=True).start()
            else:
                self._json(404, {"error": f"no such endpoint: {self.path}"})
        except StandbyReadOnlyError as e:
            # before the MetisError catch: a mutation on a standby is not
            # a bad request — 503 + the standby flag tells a failover-
            # aware client to try the next address in its list
            self._json(503, {"error": f"{type(e).__name__}: {e}",
                             "standby": True})
        except (KeyError, TypeError, ValueError, MetisError) as e:
            self._json(400, {"error": f"{type(e).__name__}: {e}"})
        except Exception as e:  # pragma: no cover - last-resort 500
            self._json(500, {"error": f"{type(e).__name__}: {e}"})


class _ServiceShutdownMixin:
    """Close the PlanService BEFORE stopping the serve loop: ``shutdown()``
    joins ``serve_forever``, which cannot finish while a handler thread
    sits in a long-polled ``GET /notifications`` wait — ``service.close()``
    wakes those waiters first, so shutdown never hangs behind a blocked
    poller (and pollers get a prompt empty response instead of a dropped
    socket)."""

    def shutdown(self) -> None:
        service = getattr(self, "service", None)
        if service is not None:
            service.close()
        super().shutdown()


class _WorkerPoolMixin:
    """Bounded worker-thread pool in place of ThreadingMixIn's
    thread-per-connection.

    Under keep-alive, a connection IS a long-lived unit of work (one
    handler thread serves it until it closes), so unbounded spawning
    turns a connection flood into a thread flood.  Here ``accept`` stays
    cheap: ``process_request`` enqueues the connection on a bounded
    queue; ``pool_threads`` resident workers drain it.  When pool AND
    backlog are both full, the server sheds load honestly — a raw
    ``503`` with ``Retry-After: 1`` and ``Connection: close`` written
    straight to the socket — instead of accepting work it cannot start.
    """

    pool_threads = 64
    pool_backlog = 128

    def init_pool(self, threads: int | None = None) -> None:
        """Start the workers.  Call AFTER ``server.service`` is set (the
        pool metrics live in the service's registry); ``make_server``
        does this."""
        if threads is not None and threads >= 1:
            self.pool_threads = int(threads)
        m = self.service.metrics
        self._task_q: queue.Queue = queue.Queue(self.pool_backlog)
        self._backlog_gauge = m.gauge("metis_serve_pool_backlog")
        self._busy_gauge = m.gauge("metis_serve_pool_busy_threads")
        self._wait_hist = m.histogram("metis_serve_pool_queue_wait_ms")
        self._overload_counter = m.counter("metis_serve_overload_total")
        m.gauge("metis_serve_pool_threads").set(self.pool_threads)
        for i in range(self.pool_threads):
            threading.Thread(target=self._worker_loop,
                             name=f"metis-serve-worker-{i}",
                             daemon=True).start()

    def pool_backlog_size(self) -> int:
        q = getattr(self, "_task_q", None)
        return q.qsize() if q is not None else 0

    def process_request(self, request, client_address) -> None:
        q = getattr(self, "_task_q", None)
        if q is None:  # pool never initialised: serve inline (tests)
            super().process_request(request, client_address)
            return
        try:
            q.put_nowait((request, client_address, time.perf_counter()))
        except queue.Full:
            self._reject_overload(request)
            return
        self._backlog_gauge.set(q.qsize())

    def _worker_loop(self) -> None:
        while True:
            item = self._task_q.get()
            if item is None:
                return
            request, client_address, t_enq = item
            self._wait_hist.observe(
                (time.perf_counter() - t_enq) * 1000)
            self._backlog_gauge.set(self._task_q.qsize())
            self._busy_gauge.inc()
            try:
                self.finish_request(request, client_address)
            except Exception:
                self.handle_error(request, client_address)
            finally:
                self._busy_gauge.dec()
                self.shutdown_request(request)

    def _reject_overload(self, request) -> None:
        """Every worker busy and the backlog full: answer 503 without a
        handler (there is no thread to run one) and close."""
        body = (b'{"error": "server overloaded: worker pool and backlog'
                b' full", "retry_after_s": 1}')
        head = (b"HTTP/1.1 503 Service Unavailable\r\n"
                b"Content-Type: application/json\r\n"
                b"Content-Length: " + str(len(body)).encode() +
                b"\r\nRetry-After: 1\r\nConnection: close\r\n\r\n")
        try:
            request.sendall(head + body)
        except OSError:  # peer already gone — shedding still succeeded
            pass
        self._overload_counter.inc()
        service = getattr(self, "service", None)
        if service is not None:
            service.counters.inc("serve.overload")
            service.events.emit("serve_overload",
                                backlog=self.pool_backlog,
                                threads=self.pool_threads)
        self.shutdown_request(request)

    def server_close(self) -> None:
        q = getattr(self, "_task_q", None)
        if q is not None:
            for _ in range(self.pool_threads):
                try:
                    q.put_nowait(None)
                except queue.Full:  # workers are daemons; best-effort
                    break
        super().server_close()


class _TCPServer(_WorkerPoolMixin, _ServiceShutdownMixin, HTTPServer):
    """Loopback TCP server tuned for bursty local clients: the default
    listen backlog of 5 resets connections the moment 64 threads connect
    at once, which the smoke tool's concurrency contract forbids."""

    request_queue_size = 128


class _UnixHTTPServer(_WorkerPoolMixin, _ServiceShutdownMixin, HTTPServer):
    """Pool-backed HTTP server over an AF_UNIX socket path."""

    address_family = socket.AF_UNIX
    request_queue_size = 128

    def __init__(self, path: str, handler) -> None:
        self._socket_path = path
        if os.path.exists(path):
            os.unlink(path)
        super().__init__(path, handler)

    def server_bind(self) -> None:
        # HTTPServer.server_bind assumes a (host, port) address; a unix
        # path has neither, so bind directly and stub the name fields
        self.socket.bind(self.server_address)
        self.server_name = "localhost"
        self.server_port = 0

    def server_close(self) -> None:
        super().server_close()
        try:
            os.unlink(self._socket_path)
        except OSError:
            pass


def make_server(service: PlanService, host: str = "127.0.0.1",
                port: int = 0, socket_path: str | Path | None = None,
                threads: int | None = None):
    """Bound, ready-to-serve HTTP server; ``server.address`` is the
    client-facing address string (``http://...`` or ``unix:...``).
    ``threads`` sizes the handler worker pool (default
    ``_WorkerPoolMixin.pool_threads``)."""
    if socket_path is not None:
        server = _UnixHTTPServer(str(socket_path), _Handler)
        server.address = f"unix:{socket_path}"
    else:
        server = _TCPServer((host, port), _Handler)
        bound_host, bound_port = server.server_address[:2]
        server.address = f"http://{bound_host}:{bound_port}"
    server.service = service
    server.init_pool(threads)
    return server


def serve_in_thread(service: PlanService, host: str = "127.0.0.1",
                    port: int = 0, socket_path: str | Path | None = None,
                    threads: int | None = None):
    """Start serving on a background thread.

    Returns ``(server, thread, address)`` — the in-process boot path the
    smoke tool, tests, and bench use.  ``POST /shutdown`` (or
    ``server.shutdown()``) ends the thread; then ``server.server_close()``.
    """
    server = make_server(service, host=host, port=port,
                         socket_path=socket_path, threads=threads)
    thread = threading.Thread(target=server.serve_forever,
                              name="metis-serve", daemon=True)
    thread.start()
    return server, thread, server.address


def run_server(server) -> None:
    """Blocking serve loop for the CLI; Ctrl-C exits cleanly."""
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
