"""Persistent cold-search worker pool for the plan daemon — the port of
``metis_tpu/serve/pool.py``.  Its workers start with ``spawn``
(``search/parallel._mp_context``: a forked child of a process holding
torch would inherit its threads), so each imports the planner afresh (no
torch), and the profiles travel to it pickled.

``search/parallel.py`` shards a search across processes, but its search loop
(``try_parallel_plan_hetero``) forks a fresh set of workers per search —
each one pays evaluator construction and (under spawn) a full
interpreter boot before costing a single candidate, and the daemon still
serializes every cold miss behind its single ``_search_lock``.  This
module keeps the sharding and loses both costs:
:class:`SearchWorkerPool` spawns ``num_workers`` processes ONCE at
daemon boot and feeds them searches over per-worker task queues.  Each
worker holds a warm :class:`~metis_tpu_torch.search.parallel.CandidateEvaluator`
per query fingerprint (LRU-bounded, mirroring the daemon's serial-path
state table), so a repeat search after an invalidation re-prices from
hot memo tables instead of rebuilding the world.

The ranking contract is inherited, not re-implemented: every worker runs
:func:`~metis_tpu_torch.search.parallel.run_worker_shard` — literally the same
loop the one-shot workers and (via ``CandidateEvaluator``) the serial
path run — and the parent merges shards on the
``(total_ms, global_idx, seq)`` stable tie-break key, so the merged
ranking is byte-identical to the serial search (asserted in
tests/test_torch_serve_pool.py).  Workers also ship their evaluators'
``touched_nodes``/``tagged_candidates`` home so the daemon's
incremental-replan keep/drop pivot keeps working when the warm state
lives in child processes.

Searches from concurrent daemon threads interleave at task granularity:
each worker drains its queue in order, so two cold misses pipeline
through the pool instead of one blocking the other for its full wall
time — and the daemon thread never holds the global search lock while
the pool runs.  Any worker failure raises :class:`SearchPoolError`; the
daemon answers that query on the serial fallback path and the response
is byte-identical either way.
"""
from __future__ import annotations

import itertools
import queue as _queue
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

from metis_tpu_torch.core.errors import MetisError
from metis_tpu_torch.core.events import EventLog, NULL_LOG
from metis_tpu_torch.core.trace import Counters
from metis_tpu_torch.obs.metrics import NULL_METRICS, MetricsRegistry
from metis_tpu_torch.search.parallel import (CandidateEvaluator, _mp_context,
                                       build_shard_pruner, run_worker_shard)


class SearchPoolError(MetisError):
    """The pool cannot answer this search (worker died, queue stuck,
    unpicklable inputs) — the daemon's signal to fall back to the serial
    path."""


@dataclass
class PoolSearchOutcome:
    """One merged pool search: the serial-identical ranking plus the
    accounting the daemon folds into its entry/decision/state tables."""

    plans: list  # RankedPlan, merged + truncated, serial-identical order
    num_costed: int
    num_pruned: int
    num_bound_pruned: int
    search_seconds: float
    counters: dict = field(default_factory=dict)
    touched_nodes: frozenset = frozenset()
    tagged_candidates: int = 0
    warm: bool = False  # every worker answered from a warm evaluator


def _pool_worker_main(worker_id, num_workers, task_q, out_q, profiles,
                      state_capacity):
    """Resident worker process: drain tasks forever (None = shut down).

    State table: query fingerprint -> (CandidateEvaluator, Counters),
    LRU-bounded at ``state_capacity`` like the daemon's serial-path
    table.  A fingerprint keys model x cluster x config, so a warm hit
    is guaranteed to be for identical search inputs.  Counter deltas
    (not totals — the evaluator's counters accumulate across searches)
    ship home per task so the parent's merge reconciles per-search.
    """
    states: OrderedDict[str, tuple] = OrderedDict()
    while True:
        msg = task_q.get()
        if msg is None:
            return
        kind, task_id, qfp, cluster, model, config, top_k, node_ids = msg
        try:
            slot = states.get(qfp)
            warm = slot is not None
            if slot is None:
                counters = Counters()
                ctx = CandidateEvaluator(cluster, profiles, model, config,
                                         counters=counters,
                                         node_ids=node_ids)
                states[qfp] = (ctx, counters)
                while len(states) > state_capacity:
                    states.popitem(last=False)
            else:
                ctx, counters = slot
                states.move_to_end(qfp)
            if kind == "prewarm":
                out_q.put(("result", task_id, worker_id, [], {}, 0, 0, 0,
                           (), 0, warm))
                continue
            base = counters.as_dict()
            pruner = build_shard_pruner(ctx, profiles)
            plans, num_costed, pruned, bound_pruned = run_worker_shard(
                ctx, pruner, worker_id, num_workers, top_k=top_k,
                progress=lambda ticks, elapsed, best, n_plans, n_pruned:
                    out_q.put(("progress", task_id, worker_id, ticks,
                               elapsed, best, n_plans, n_pruned)))
            now = counters.as_dict()
            delta = {k: v - base.get(k, 0) for k, v in now.items()
                     if v - base.get(k, 0)}
            out_q.put(("result", task_id, worker_id, plans, delta,
                       num_costed, pruned, bound_pruned,
                       tuple(ctx.touched_nodes), ctx.tagged_candidates,
                       warm))
        except BaseException as e:  # noqa: BLE001 — parent falls back
            out_q.put(("error", task_id, worker_id,
                       f"{type(e).__name__}: {e}"))


class SearchWorkerPool:
    """``num_workers`` resident index-stride search processes behind the
    daemon.  ``profiles`` is shipped once at spawn; the (possibly
    delta-mutated) cluster rides each task, so an elastic topology change
    needs no pool restart — the new fingerprint simply builds fresh warm
    state and the old states age out of the worker LRUs."""

    def __init__(self, cluster, profiles, num_workers: int, *,
                 state_capacity: int = 8,
                 metrics: MetricsRegistry = NULL_METRICS,
                 result_timeout_s: float = 600.0):
        if num_workers < 1:
            raise ValueError(
                f"num_workers must be >= 1, got {num_workers}")
        ctx = _mp_context()
        if ctx is None:
            raise SearchPoolError(
                "no multiprocessing start method available")
        self.num_workers = num_workers
        self.metrics = metrics
        self.result_timeout_s = result_timeout_s
        self._task_ids = itertools.count(1)
        self._lock = threading.Lock()
        self._waiters: dict[int, _queue.Queue] = {}
        self._closed = False
        self._out_q = ctx.Queue()
        self._task_qs = [ctx.Queue() for _ in range(num_workers)]
        self._procs = []
        try:
            for wid in range(num_workers):
                p = ctx.Process(
                    target=_pool_worker_main,
                    args=(wid, num_workers, self._task_qs[wid],
                          self._out_q, profiles, state_capacity),
                    daemon=True)
                p.start()
                self._procs.append(p)
        except OSError as e:
            self.close()
            raise SearchPoolError(
                f"worker start failed: {type(e).__name__}: {e}") from e
        self.metrics.gauge("metis_search_pool_workers").set(num_workers)
        self._inflight = self.metrics.gauge("metis_search_pool_inflight")
        self._collector = threading.Thread(
            target=self._collect, name="metis-search-pool-collect",
            daemon=True)
        self._collector.start()

    # -- result routing ------------------------------------------------------
    def _collect(self) -> None:
        """Single reader of the shared result queue, routing every
        message to its task's waiter — what lets concurrent daemon
        threads await different searches without stealing each other's
        messages."""
        while True:
            try:
                msg = self._out_q.get(timeout=0.5)
            except (_queue.Empty, OSError, EOFError, ValueError):
                if self._closed:
                    return
                continue
            with self._lock:
                waiter = self._waiters.get(msg[1])
            if waiter is not None:
                waiter.put(msg)

    def _check_alive(self) -> None:
        dead = [wid for wid, p in enumerate(self._procs)
                if not p.is_alive()]
        if dead:
            raise SearchPoolError(
                f"search pool worker(s) {dead} died "
                f"(exit codes {[self._procs[w].exitcode for w in dead]})")

    # -- search --------------------------------------------------------------
    def search(self, qfp: str, cluster, model, config,
               top_k: int | None, node_ids,
               events: EventLog = NULL_LOG) -> PoolSearchOutcome:
        """One sharded search: broadcast to every worker, merge on the
        serial stable tie-break key.  Raises :class:`SearchPoolError` on
        any worker failure or timeout — never a partial ranking."""
        return self._run("search", qfp, cluster, model, config, top_k,
                         node_ids, events)

    def prewarm(self, qfp: str, cluster, model, config,
                node_ids) -> None:
        """Build (or refresh) every worker's warm evaluator for this
        query shape without running a search — the boot-time analogue of
        the daemon priming its serial state table."""
        self._run("prewarm", qfp, cluster, model, config, None, node_ids,
                  NULL_LOG)

    def _run(self, kind: str, qfp: str, cluster, model, config,
             top_k: int | None, node_ids,
             events: EventLog) -> PoolSearchOutcome:
        if self._closed:
            raise SearchPoolError("search pool is closed")
        self._check_alive()
        task_id = next(self._task_ids)
        waiter: _queue.Queue = _queue.Queue()
        with self._lock:
            self._waiters[task_id] = waiter
        t0 = time.perf_counter()
        self._inflight.inc()
        try:
            task = (kind, task_id, qfp, cluster, model, config, top_k,
                    tuple(node_ids))
            for q in self._task_qs:
                q.put(task)
            results: dict[int, tuple] = {}
            deadline = t0 + self.result_timeout_s
            while len(results) < self.num_workers:
                try:
                    msg = waiter.get(timeout=1.0)
                except _queue.Empty:
                    self._check_alive()
                    if time.perf_counter() > deadline:
                        raise SearchPoolError(
                            f"search pool task {task_id} timed out after "
                            f"{self.result_timeout_s:.0f}s") from None
                    continue
                if msg[0] == "error":
                    raise SearchPoolError(
                        f"search pool worker {msg[2]} raised: {msg[3]}")
                if msg[0] == "progress":
                    _, _, wid, ticks, elapsed, best, n_plans, n_pruned = msg
                    events.emit(
                        "search_progress", n=ticks,
                        elapsed_s=round(elapsed, 3),
                        per_s=(round(ticks / elapsed, 1)
                               if elapsed > 0 else None),
                        worker=wid, best_cost_ms=best,
                        num_costed=n_plans, num_pruned=n_pruned)
                    continue
                results[msg[2]] = msg[3:]
        finally:
            self._inflight.dec()
            with self._lock:
                self._waiters.pop(task_id, None)
        merged: list[tuple] = []
        counters: dict[str, int] = {}
        num_costed = pruned = bound_pruned = tagged = 0
        touched: set = set()
        warm_all = True
        for wid in range(self.num_workers):
            (w_plans, w_counters, w_costed, w_pruned, w_bound,
             w_touched, w_tagged, w_warm) = results[wid]
            merged.extend(w_plans)
            num_costed += w_costed
            pruned += w_pruned
            bound_pruned += w_bound
            touched.update(w_touched)
            tagged += w_tagged
            warm_all = warm_all and w_warm
            for k, v in (w_counters or {}).items():
                counters[k] = counters.get(k, 0) + v
        # (total_ms, global candidate idx, per-candidate yield seq): the
        # serial path's stable sort over its insertion order is exactly a
        # sort by this key, so the merge reproduces it byte-for-byte
        merged.sort(key=lambda rec: rec[:3])
        plans = [rec[3] for rec in merged]
        if top_k is not None:
            plans = plans[:top_k]
        return PoolSearchOutcome(
            plans=plans, num_costed=num_costed, num_pruned=pruned,
            num_bound_pruned=bound_pruned,
            search_seconds=time.perf_counter() - t0,
            counters=counters, touched_nodes=frozenset(touched),
            tagged_candidates=tagged, warm=warm_all)

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Stop every worker (sentinel, then join, then terminate
        stragglers).  Idempotent."""
        if self._closed:
            return
        self._closed = True
        for q in getattr(self, "_task_qs", []):
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        for p in getattr(self, "_procs", []):
            p.join(timeout=5.0)
        for p in getattr(self, "_procs", []):
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)
        self.metrics.gauge("metis_search_pool_workers").set(0)
