"""The event-log schema — the port's copy of what
``tools/check_events_schema.py`` checks, for the drills of the package
(``resilience/fleet_drill.py``), which run where ``tools/`` is not on the
path.

The schema is the README "Observability" section's contract: every line is
a JSON object with a numeric ``ts`` and a string ``event``; every event
name is one the codebase emits; each event carries its required fields.
``validate_events(list_of_dicts) -> list[str]`` lists the problems.
"""
from __future__ import annotations

# event name -> fields required beyond the universal ts/event.
# Emitters: planner/api.py (search_*, plan_explain, counters, spans via
# core/trace.py), planner/cli.py + execution/train.py (train_step),
# profiles/profiler.py (profile_*), obs/ledger.py (accuracy_sample via
# AccuracyMonitor, drift_alarm via DriftDetector).
EVENT_SCHEMA: dict[str, set[str]] = {
    "search_started": {"mode", "devices", "gbs"},
    "search_finished": {"mode", "num_costed", "num_pruned", "seconds"},
    # a parallel run (SearchConfig.workers > 1) tags each heartbeat with
    # the integer ``worker`` id that emitted it; serial heartbeats omit it
    "search_progress": {"n", "elapsed_s"},
    # parallel search fell back to the serial loop (search/parallel.py):
    # unpicklable inputs, no start method, or a worker failure — also
    # emitted by the daemon when its resident search pool fails a query
    # (serve/pool.py) and the serial path answers instead
    "parallel_fallback": {"reason"},
    # the serve transport shed a connection with 503 + Retry-After
    # because the handler worker pool and its backlog were both full
    # (serve/daemon.py _WorkerPoolMixin)
    "serve_overload": {"backlog", "threads"},
    "counters": {"scope", "counters"},
    "span_begin": {"name", "span_id", "path"},
    "span_end": {"name", "span_id", "path", "dur_ms"},
    "train_step": {"step"},
    "profile_started": {"device_type"},
    "profile_measured": {"device_type", "tp", "bs"},
    "profile_skipped": {"tp", "reason"},
    "profile_finished": {"device_type"},
    # cost-model explainability + accuracy (obs/ledger.py, planner/api.py)
    "plan_explain": {"rank", "fingerprint", "total_ms", "components"},
    "accuracy_sample": {"fingerprint", "predicted_ms", "measured_ms",
                        "error_pct"},
    "drift_alarm": {"mape_pct", "band_pct", "n"},
    # communication overlap (execution/pipeline.py, cost/calibration.py);
    # dp_chunk_elems is 0 on the gpipe path (autodiff-inserted dp
    # reduction — chunking does not apply)
    "pipeline_overlap": {"schedule", "dp_chunk_elems"},
    "overlap_measured": {"lockstep_ms", "overlapped_ms",
                         "overlap_hidden_frac"},
    # planner-as-a-service (serve/daemon.py): one plan_request per query,
    # then exactly one of plan_cache_hit / plan_cache_miss; replan_push
    # when a drift alarm re-searched a served plan (carries
    # new_fingerprint + the notification seq subscribers long-poll for)
    "plan_request": {"fingerprint"},
    "plan_cache_hit": {"fingerprint"},
    "plan_cache_miss": {"fingerprint"},
    "replan_push": {"fingerprint", "new_fingerprint", "reason"},
    # serving-workload planning (inference/planner.py, inference/replay.py,
    # profiles/profiler.py): one inference_plan per ranked serving plan
    # (prefix_share_frac/kv_page_tokens record the paged-sharing model the
    # KV math used); slo_violation when the best plan misses a p99 target
    # (metric names which); replay_tick per simulated tick of the
    # traffic-replay bench; decode_profile per measured (tp, bs)
    # KV-resident single-token step (metis-tpu profile --decode);
    # autoscale_forecast per predictive-policy tick — the forecasted
    # demand, the ceiling it was judged against, and the action taken
    "inference_plan": {"rank", "ttft_p99_ms", "tpot_p99_ms", "max_rps",
                       "prefix_share_frac", "kv_page_tokens"},
    "slo_violation": {"metric", "value", "slo"},
    "replay_tick": {"t_s", "arrival_rps", "devices", "slo_ok"},
    "decode_profile": {"device_type", "tp", "bs", "context_len", "step_ms"},
    "autoscale_forecast": {"t_s", "forecast_rps", "ceiling_rps", "action"},
    # fault tolerance (resilience/ — faults.py, retry.py, supervisor.py)
    "fault_injected": {"point"},
    "retry_attempt": {"op", "attempt"},
    "retry_exhausted": {"op", "attempts"},
    "anomaly_detected": {"kind", "step"},
    "preempt_drain": {"step"},
    "recovery_complete": {"step", "recover_s"},
    # spot-fleet availability (resilience/supervisor.py spot paths,
    # tools/fleet_drill.py): one preemption per spot eviction (before its
    # shrink->replan->restore recovery), one spot_return per capacity
    # return (before its grow->replan), one fleet_tick per simulated tick
    # of the fleet drill, one recovery_cost per realized recovery charge
    "preemption": {"step", "lost", "tier"},
    "spot_return": {"step", "returned"},
    "fleet_tick": {"tick", "devices", "goodput_frac"},
    "recovery_cost": {"tick", "recover_s"},
    # live plan migration (execution/reshard.py, resilience/supervisor.py,
    # tools/fleet_drill.py): one reshard_plan per migration attempt (the
    # src->dst delta about to be transferred), one reshard_step per leaf
    # moved, migration_complete on digest-verified success — or
    # migration_fallback when a migration fault degrades the switch to
    # the checkpoint-restore path (state is never lost, only slower)
    "reshard_plan": {"leaves", "moved_bytes"},
    "reshard_step": {"leaf"},
    "migration_fallback": {"reason"},
    "migration_complete": {"leaves", "stall_ms"},
    # multi-tenant fleet scheduling (sched/fleet.py via serve/daemon.py,
    # tools/fleet_drill.py --tenants): tenant_admit per admission,
    # fleet_objective per re-partition (the scored winning carve),
    # tenant_preempt when a capacity change shrinks a tenant's carve
    # (never below its quota floor), tenant_replan for every carve
    # change — carrying the migrate-vs-checkpoint-restore decision
    "tenant_admit": {"tenant", "priority", "kind", "quota_floor"},
    "fleet_objective": {"objective", "utilization_frac", "tenants",
                        "shares_label", "cluster_devices"},
    "tenant_preempt": {"tenant", "from_devices", "to_devices", "priority"},
    "tenant_replan": {"tenant", "devices", "path"},
    # sub-second replanning at scale (serve/daemon.py, planner/api.py):
    # one incremental_replan per cluster delta — which reference node ids
    # changed width, how many warm search states / cached candidates were
    # kept vs dropped, and how many cache entries were invalidated; one
    # symmetry_collapse per hetero search on a cluster with cost-equivalent
    # device types (the class map plus replayed-vs-freshly-costed split);
    # one cost_backend per search running a non-default cost backend
    "incremental_replan": {"changed_nodes", "states_kept", "states_dropped",
                           "reused", "recosted", "invalidated"},
    "symmetry_collapse": {"classes", "total_sequences", "distinct_sequences",
                          "collapse_frac", "replayed", "costed_fresh"},
    "cost_backend": {"backend", "batch_fast"},
    # exact branch-and-bound backend (search/exact.py, backend="exact"):
    # one bnb_progress per node expansion (frontier state for live gap
    # tracking), one certificate per search — the proven lower bound, gap
    # fraction, and node accounting attached to the PlannerResult
    "bnb_progress": {"nodes_explored", "nodes_bounded", "best_ms",
                     "bound_ms"},
    "certificate": {"best_ms", "lower_bound_ms", "gap_frac",
                    "nodes_explored", "nodes_bounded", "wall_s"},
    # size-based log rotation (core/events.EventLog max_bytes): the first
    # record of every fresh file after a roll — where the predecessor
    # went and how large it was when it rolled
    "event_log_rotated": {"rotated_to", "size_bytes"},
    # plan provenance (obs/provenance.py): one decision_record per
    # DecisionLog append — the seq joins the event stream to the durable
    # decision log (`metis-tpu why` walks the latter; traces show the
    # former); one get_request per monitoring GET the daemon serves
    # (serve/daemon.py), stamped with the caller's trace_id when given
    "decision_record": {"seq", "kind"},
    "get_request": {"endpoint"},
    # durable control plane (serve/persist.py, serve/standby.py): one
    # snapshot_write per persisted state snapshot (op-seq cursor, cache
    # entries captured, bytes on disk); one snapshot_restore per boot
    # that found state (source = latest / prev generation, or "oplog"
    # when only the log existed); one oplog_append per state-mutation op;
    # one failover per standby promotion (last replicated seq + why)
    "snapshot_write": {"seq", "entries", "bytes"},
    "snapshot_restore": {"seq", "entries", "source"},
    "oplog_append": {"seq", "op"},
    "failover": {"last_seq", "reason"},
    # planning under uncertainty (cost/uncertainty.py, cost/calibration.py,
    # obs/ledger.py): one residual_fit per ledger-fit ResidualModel (the
    # pooled relative-sigma + fit kind the risk ranking runs on); one
    # transfer_fit per cross-device profile transfer (the roofline scale
    # factors applied to the unprofiled target type); one ledger_skip per
    # ledger load that dropped malformed lines — the per-reason tally of
    # torn/NaN/valueless records skipped instead of poisoning fits
    "residual_fit": {"n_samples", "n_device_types", "rel_sigma", "kind"},
    "transfer_fit": {"source_type", "target_type", "time_scale",
                     "compute_scale", "mem_scale", "n_entries"},
    "ledger_skip": {"n_skipped", "reasons"},
}

# Events the serve daemon emits once per client request.  When a client
# mints trace_ids (serve/client.py does, always), the daemon stamps them
# onto every event a request causes — so in a daemon log where ANY event
# carries a trace_id, every request-scoped event must.  A partial stamp
# means a code path lost the binding (exactly the regression the
# end-to-end tracing contract exists to catch).
REQUEST_SCOPED_EVENTS = {"plan_request", "plan_cache_hit",
                         "plan_cache_miss", "replan_push", "get_request"}

# decision_record events are request-scoped only for the decision kinds
# that happen INSIDE a client request (a cold search or a cache hit);
# fleet re-partitions and background replans legitimately outlive or
# precede any single request, so their stamps are best-effort.
REQUEST_SCOPED_DECISION_KINDS = {"cold_search", "cache_hit"}


def validate_events(events: list[dict]) -> list[str]:
    """Problems (empty = valid) for already-parsed event dicts."""
    problems: list[str] = []
    traced = any(isinstance(ev, dict) and ev.get("trace_id")
                 for ev in events)
    for i, ev in enumerate(events, 1):
        where = f"event {i}"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not a JSON object")
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            problems.append(f"{where}: missing/non-numeric 'ts'")
        name = ev.get("event")
        if not isinstance(name, str):
            problems.append(f"{where}: missing/non-string 'event'")
            continue
        required = EVENT_SCHEMA.get(name)
        if required is None:
            problems.append(f"{where}: unknown event name {name!r}")
            continue
        missing = sorted(required - set(ev))
        if missing:
            problems.append(f"{where} ({name}): missing fields {missing}")
        if "trace_id" in ev and not (isinstance(ev["trace_id"], str)
                                     and ev["trace_id"]):
            problems.append(
                f"{where} ({name}): trace_id must be a non-empty string")
        elif traced and name in REQUEST_SCOPED_EVENTS \
                and not ev.get("trace_id"):
            problems.append(
                f"{where} ({name}): request-scoped event missing trace_id "
                "in a traced log")
        elif traced and name == "decision_record" \
                and ev.get("kind") in REQUEST_SCOPED_DECISION_KINDS \
                and not ev.get("trace_id"):
            problems.append(
                f"{where} (decision_record/{ev.get('kind')}): "
                "request-scoped decision missing trace_id in a traced log")
    return problems
