"""Fleet-scale availability chaos drill: spot preemptions against the
serve daemon, end-to-end through the availability-aware cost model — the
port of ``tools/fleet_drill.py``.

Two legs, fully deterministic for a given ``--seed`` (the first on the
host; the second on the card unless the caller asks for the CPU):

1. **The fleet simulation** (``run_fleet_drill``): a 256-device mixed
   fleet — a reserved v6e pool plus a spot v5e pool carrying a nonzero
   ``preemption_rate_per_hr`` — planned by a live in-thread serve daemon.
   Each simulated tick draws node-level spot evictions and returns from a
   seeded Poisson process; every eviction becomes a
   ``POST /cluster_delta`` shrink (the daemon replans on the survivors and
   pushes ``replan_push``), every return a grow.  The drill records a
   goodput/recovery-cost trajectory and asserts the recovery guarantees:
   every shrunk topology replans feasibly, the fleet drains back to full
   capacity, and the final plan is byte-identical to the pre-chaos
   baseline.  The headline is ``fleet_goodput_frac`` — mean per-tick
   throughput relative to the full healthy fleet, discounted by
   recovery downtime (``SearchConfig.spot_recover_s`` per event).

   With migration on (the default), eligible topology transitions take
   the **live-migration path** instead of checkpoint-restore: the
   reserved pool survives every delta (old and new device sets always
   intersect), so when the priced transfer
   (:func:`metis_tpu_torch.cost.migration.price_migration_ms` over the old
   and new stage layouts — the supervisor's exact decision rule) beats
   ``spot_recover_s``, the tick is charged the modeled migration stall
   only.  Each migration reshards a synthetic per-layer state through a
   serialized transfer and asserts the result bit-identical by sha256
   digest; the first eligible migration absorbs an injected
   ``reshard_verify`` fault and must fall back to the full
   checkpoint-restore charge with a ``migration_fallback`` event.  (The
   fleet plans are hetero — the live reshard itself is exercised by the
   supervisor's migration paths, ``execution/reshard.py``; this leg proves
   the fleet-scale *policy* and its pricing.)
2. **The supervisor leg** (``run_supervisor_spot_drill``): the reference
   drill's tiny model (``drill_setup``: 2 nodes x 4 A100) under the port's
   ``TrainingSupervisor``, one gloo rank per device of the cluster (eight
   ranks sharing the card, or eight CPU ranks with ``device="cpu"``), with
   a scripted
   ``spot_preemption`` -> ``spot_return`` pair — proves eviction is
   handled as shrink -> replan -> checkpoint restore and returned capacity
   as grow -> replan, with the event stream causally ordered
   (``preemption`` before its ``recovery_complete``, ``spot_return``
   before the grow's).

With ``--tenants N`` the drill runs the **multi-tenant leg**
(``run_tenant_drill``) instead: N >= 3 tenants — steady training at two
priorities plus a diurnal inference service — share one fleet through the
``metis_tpu_torch.sched`` fleet scheduler behind the same live daemon.  Seeded
Poisson spot evictions and returns hit the shared capacity; every tick
asserts that each surviving tenant holds a valid plan at or above its
quota floor, the event stream is causally ordered (admits before chaos;
each ``tenant_preempt`` between its capacity change's re-partition
``fleet_objective`` and a ``tenant_replan`` for the same tenant), and the
closing fleet state after the drain tick is byte-identical to the
pre-chaos baseline.  Headlines: ``fleet_utilization_frac`` and per-tenant
SLO attainment (training: planned every tick; inference: planned AND the
carve's throughput covers the tick's diurnal demand).

The fleet TPUs (a reserved v6e pool, a spot v5e pool) are the
reference's slices (``cluster/tpu.py``), lowered to their scalar
``DeviceSpec``s (``slice_device_spec``).  The fleet and tenant legs run on
the host; the
fleet leg imports no torch (the tenant leg's scheduler does, for its
switch decisions' plan artifacts, ``sched/fleet.py``).

Run through the CLI (``python -m metis_tpu_torch chaos --fleet``), or
``python tools/torch_fleet_drill.py``; both take ``main``'s arguments.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import random
import tempfile
from pathlib import Path

import numpy as np

from metis_tpu_torch.cluster.spec import ClusterSpec, DeviceSpec
from metis_tpu_torch.cluster.tpu import slice_from_name
from metis_tpu_torch.core.config import ModelSpec, SearchConfig
from metis_tpu_torch.core.events import EventLog, read_events, read_events_rotated
from metis_tpu_torch.obs.events_schema import validate_events

RESERVED_TYPE = "tpu_v6e"
SPOT_TYPE = "tpu_v5e"


def slice_device_spec(generation: str, chips: int) -> DeviceSpec:
    """The scalar view of a slice of ``chips`` chips of ``generation``
    (``TpuSliceSpec.as_device_spec``): memory the chip's HBM, inter
    bandwidth the host's DCN, intra bandwidth the ICI ring of the slowest
    torus axis."""
    return slice_from_name(f"{generation}-{chips}").as_device_spec()


def fleet_model() -> ModelSpec:
    """Planner-scale model for the fleet simulation (never trained)."""
    return ModelSpec(name="gpt-fleet", num_layers=24, hidden_size=2048,
                     sequence_length=1024, vocab_size=32000, num_heads=16)


def fleet_cluster(devices: int = 256, chips_per_node: int = 32,
                  spot_rate_per_hr: float = 0.05) -> ClusterSpec:
    """Half reserved v6e, half spot v5e (``tier="spot"`` with a per-device
    preemption hazard).  Spot nodes sit at the END of the node sequence so
    shrink's peel-from-the-end convention evicts spot capacity first."""
    half = devices // 2
    spot_spec = dataclasses.replace(
        slice_device_spec(SPOT_TYPE, half), tier="spot",
        preemption_rate_per_hr=spot_rate_per_hr)
    nodes = (slice_from_name(f"{RESERVED_TYPE}-{half}").as_nodes(chips_per_node)
             + slice_from_name(f"{SPOT_TYPE}-{half}").as_nodes(chips_per_node))
    return ClusterSpec(nodes=tuple(nodes),
                       devices={RESERVED_TYPE: slice_device_spec(RESERVED_TYPE, half),
                                SPOT_TYPE: spot_spec})


def fleet_search_config(spot_recover_s: float = 30.0) -> SearchConfig:
    return SearchConfig(gbs=256, max_profiled_tp=4, max_profiled_bs=8,
                        use_spot_model=True, spot_recover_s=spot_recover_s)


def tenant_model() -> ModelSpec:
    """Per-tenant planner-scale model for the multi-tenant leg — smaller
    than :func:`fleet_model` because every re-partition candidate costs
    one planner search per tenant sub-cluster."""
    return ModelSpec(name="gpt-tenant", num_layers=8, hidden_size=1024,
                     sequence_length=512, vocab_size=32000, num_heads=8)


def _best_recovery_ms(resp: dict) -> float:
    """The ranked-best plan's expected_recovery_ms from a daemon /plan
    response (absent = exactly 0.0 by the golden-stability contract)."""
    try:
        plans = json.loads(resp.get("plans") or "[]")
        cost = (plans[0].get("cost_breakdown") or {}) if plans else {}
        return float(cost.get("expected_recovery_ms", 0.0))
    except (ValueError, AttributeError, IndexError):
        return 0.0


def _plan_layout(resp: dict) -> tuple | None:
    """The ranked-best plan's per-stage ``(tp, layer_start, layer_end)``
    triples from a daemon /plan response — the canonical layout shape
    ``cost.migration`` prices migrations over."""
    try:
        plans = json.loads(resp.get("plans") or "[]")
        if not plans:
            return None
        bounds = list(plans[0]["layer_partition"])
        tps = [int(s["tp"]) for s in plans[0]["strategies"]]
        return tuple((tps[i], int(bounds[i]), int(bounds[i + 1]))
                     for i in range(len(tps)))
    except (KeyError, ValueError, IndexError, TypeError, AttributeError):
        return None


def _synthetic_state(num_layers: int, seed: int) -> list[np.ndarray]:
    """One seeded array per layer — a fleet-scale stand-in for live
    training state, small enough to digest every migration."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(1024).astype(np.float32)
            for _ in range(num_layers)]


def _state_digest(state: list[np.ndarray]) -> str:
    h = hashlib.sha256()
    for a in state:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _simulate_reshard(state: list[np.ndarray], old_layout: tuple,
                      new_layout: tuple) -> tuple[list[np.ndarray], int]:
    """Round-trip every layer whose stage tp assignment changed through a
    serialized transfer buffer (the same moved-layer rule as
    ``cost.migration.layout_moved_bytes``); returns (new state, layers
    moved)."""
    old_tp: dict[int, int] = {}
    for tp, start, end in old_layout:
        for layer in range(start, end):
            old_tp[layer] = tp
    out = list(state)
    moved = 0
    for tp, start, end in new_layout:
        for layer in range(start, end):
            if old_tp.get(layer) != tp and layer < len(state):
                a = state[layer]
                out[layer] = np.frombuffer(
                    a.tobytes(), dtype=a.dtype).reshape(a.shape)
                moved += 1
    return out, moved


def run_fleet_drill(tmp_dir: str | Path, *, devices: int = 256,
                    chips_per_node: int = 32, ticks: int = 24,
                    tick_seconds: float = 3600.0,
                    spot_rate_per_hr: float = 0.05,
                    return_rate_per_hr: float = 0.35,
                    spot_recover_s: float = 30.0, seed: int = 0,
                    migrate: bool = True,
                    events_max_bytes: int | None = None,
                    verbose: bool = False) -> dict:
    """Seeded Poisson preemption chaos against a live daemon.  Returns the
    fleet report dict; raises AssertionError when a recovery guarantee is
    violated.  ``migrate=False`` restores the checkpoint-restore-only
    accounting (every delta charged ``spot_recover_s``).
    ``events_max_bytes`` rotates the event log mid-drill (the rotation
    regression: the schema/causality checks must still pass over the
    ``<name>.1`` roll)."""
    from metis_tpu_torch.cost.migration import (layout_moved_bytes,
                                                price_migration_ms)
    from metis_tpu_torch.cost.volume import TransformerVolume
    from metis_tpu_torch.obs.decisions_schema import validate_file as validate_dlog
    from metis_tpu_torch.obs.provenance import DecisionLog
    from metis_tpu_torch.profiles.synthetic import synthesize_profiles
    from metis_tpu_torch.serve.client import PlanServiceClient
    from metis_tpu_torch.serve.daemon import PlanService, serve_in_thread

    tmp_dir = Path(tmp_dir)
    tmp_dir.mkdir(parents=True, exist_ok=True)
    events_path = tmp_dir / "fleet_events.jsonl"
    decisions_path = tmp_dir / "fleet_decisions.jsonl"
    model = fleet_model()
    cluster = fleet_cluster(devices, chips_per_node, spot_rate_per_hr)
    config = fleet_search_config(spot_recover_s)
    profiles = synthesize_profiles(model, [RESERVED_TYPE, SPOT_TYPE],
                                   tps=[1, 2, 4], bss=[1, 2, 4, 8])
    rng = random.Random(seed)
    # node-level hazards: a spot node evicts (and an evicted one returns)
    # within a tick with Poisson probability 1 - exp(-rate * hours)
    hours = tick_seconds / 3600.0
    p_evict = 1.0 - math.exp(-spot_rate_per_hr * hours)
    p_return = 1.0 - math.exp(-return_rate_per_hr * hours)
    n_spot_nodes = sum(1 for n in cluster.nodes if n.device_type == SPOT_TYPE)

    # live-migration bookkeeping: price over the real model volume, carry
    # a synthetic per-layer state that every migration must preserve
    # bit-identically, and arm one injected verify fault for the first
    # eligible migration (the fallback leg)
    volume = TransformerVolume(model, profiles.model.params_per_layer_bytes)
    state = _synthetic_state(model.num_layers, seed)
    state_digest0 = _state_digest(state)
    migrations = fallbacks = 0
    migration_stall_ms_total = 0.0
    fault_pending = migrate

    trajectory: list[dict] = []
    with EventLog(events_path, max_bytes=events_max_bytes) as events:
        service = PlanService(cluster, profiles, events=events,
                              decisions=DecisionLog(decisions_path,
                                                    events=events))
        server, thread, address = serve_in_thread(service)
        try:
            client = PlanServiceClient(address)
            base = client.plan(model, config, top_k=3)
            c0 = base["best_cost_ms"]
            assert c0 is not None, "full fleet is not plannable"
            base_recovery_ms = _best_recovery_ms(base)
            assert base_recovery_ms > 0.0, \
                "spot-tiered fleet priced no expected_recovery"
            prev_layout = _plan_layout(base)

            live_spot = n_spot_nodes   # mirror of the daemon's spot pool
            n_deltas = preemptions = returns = 0
            # a final drain tick returns every evicted node so the fleet
            # ends healthy and the closing plan must match the baseline
            for tick in range(ticks + 1):
                lost_nodes = returned_nodes = 0
                if tick < ticks:
                    for _ in range(live_spot):
                        if rng.random() < p_evict:
                            lost_nodes += 1
                    for _ in range(n_spot_nodes - live_spot):
                        if rng.random() < p_return:
                            returned_nodes += 1
                else:
                    returned_nodes = n_spot_nodes - live_spot
                if lost_nodes:
                    lost = {SPOT_TYPE: lost_nodes * chips_per_node}
                    events.emit("preemption", step=tick, tier="spot",
                                lost=f"{SPOT_TYPE}={lost[SPOT_TYPE]}")
                    client.cluster_delta(removed=lost, replan=True,
                                         cause="preemption")
                    live_spot -= lost_nodes
                    n_deltas += 1
                    preemptions += lost_nodes
                if returned_nodes:
                    back = {SPOT_TYPE: returned_nodes * chips_per_node}
                    events.emit("spot_return", step=tick,
                                returned=f"{SPOT_TYPE}={back[SPOT_TYPE]}")
                    client.cluster_delta(added=back, replan=True,
                                         cause="spot_return")
                    live_spot += returned_nodes
                    n_deltas += 1
                    returns += returned_nodes

                resp = client.plan(model, config, top_k=3)
                cost = resp["best_cost_ms"]
                assert cost is not None, \
                    f"tick {tick}: no feasible plan after delta " \
                    f"(live spot nodes: {live_spot})"
                n_devices = (devices // 2) + live_spot * chips_per_node
                n_events = (1 if lost_nodes else 0) \
                    + (1 if returned_nodes else 0)
                new_layout = _plan_layout(resp)
                # per eventful tick: live migration when the priced
                # transfer over the layout transition beats the
                # checkpoint-restore charge (the supervisor's decision
                # rule; the reserved v6e pool survives every delta, so
                # old and new device sets always intersect) — one modeled
                # stall covers the tick's settled transition
                recover_s = n_events * spot_recover_s
                path = "ckpt" if n_events else "none"
                if (migrate and n_events and prev_layout is not None
                        and new_layout is not None):
                    price_ms = price_migration_ms(
                        prev_layout, new_layout, volume,
                        config.migration_bw_gbps)
                    if price_ms < spot_recover_s * 1000.0:
                        if fault_pending:
                            fault_pending = False
                            fallbacks += 1
                            path = "fallback"
                            events.emit(
                                "migration_fallback", step=tick,
                                reason="MigrationError: injected "
                                       "reshard_verify fault: post-transfer"
                                       " digest mismatch")
                        else:
                            moved_bytes = layout_moved_bytes(
                                prev_layout, new_layout, volume)
                            events.emit("reshard_plan", step=tick,
                                        leaves=len(state),
                                        moved_bytes=moved_bytes)
                            state, moved = _simulate_reshard(
                                state, prev_layout, new_layout)
                            events.emit("reshard_step", step=tick,
                                        leaf=f"layers[{moved}]",
                                        bytes=moved_bytes)
                            assert _state_digest(state) == state_digest0, \
                                f"tick {tick}: migrated state diverged " \
                                "from the pre-chaos digest"
                            events.emit("migration_complete", step=tick,
                                        leaves=len(state), moved=moved,
                                        stall_ms=round(price_ms, 3))
                            recover_s = price_ms / 1000.0
                            path = "migrate"
                            migrations += 1
                            migration_stall_ms_total += price_ms
                downtime_frac = min(recover_s / tick_seconds, 1.0)
                goodput = (c0 / cost) * (1.0 - downtime_frac)
                recovery_ms = _best_recovery_ms(resp)
                if recover_s:
                    events.emit("recovery_cost", tick=tick,
                                recover_s=recover_s,
                                expected_recovery_ms=recovery_ms)
                events.emit("fleet_tick", tick=tick, devices=n_devices,
                            goodput_frac=round(goodput, 6),
                            cost_ms=cost)
                trajectory.append({
                    "tick": tick, "devices": n_devices, "cost_ms": cost,
                    "expected_recovery_ms": recovery_ms,
                    "recover_s": recover_s, "path": path,
                    "goodput_frac": goodput,
                })
                prev_layout = new_layout

            # drain the background replan notifications: one replan_push
            # per registered query per delta
            pushes, seen = 0, 0
            push_notes: list[dict] = []
            for _ in range(120 if n_deltas else 0):
                more = client.notifications(since=seen, timeout_s=1.0)
                if more:
                    seen = max(n["seq"] for n in more)
                    push_notes += [n for n in more
                                   if n.get("kind") == "replan_push"]
                    pushes = len(push_notes)
                if pushes >= n_deltas:
                    break
            final = client.plan(model, config, top_k=3)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)

    # -- the drill's guarantees -------------------------------------------
    assert preemptions > 0, \
        "seeded chaos produced no evictions — raise --ticks or --spot-rate"
    assert trajectory[-1]["devices"] == devices, \
        "fleet did not drain back to full capacity"
    assert final["best_cost_ms"] == c0, \
        f"post-chaos plan diverged from baseline: {final['best_cost_ms']} " \
        f"!= {c0}"
    assert pushes >= n_deltas, \
        f"daemon pushed {pushes} replans for {n_deltas} topology deltas"
    if migrate and n_deltas > 1:
        assert migrations > 0, \
            "no eligible topology delta took the migration path"
        assert fallbacks == 1, \
            "the injected mid-migration fault did not fall back to " \
            "checkpoint-restore"
    assert _state_digest(state) == state_digest0, \
        "state diverged across the drill's migrations"

    # -- provenance: every replan push causally chains to its eviction ----
    # Reopen the decision log FROM DISK (the daemon is down) — the audit
    # trail must be reconstructable from the JSONL alone, and it must
    # pass the decision-schema invariants (seq monotonic, parents
    # resolve, breakdown components additive).
    n_recs, dlog_problems = validate_dlog(decisions_path)
    assert not dlog_problems, \
        "decision log problems:\n  " + "\n  ".join(dlog_problems)
    audit = DecisionLog(decisions_path)
    assert len(audit) == n_recs > 0, "decision log did not persist"
    chains_verified = 0
    for note in push_notes:
        dseq = note.get("decision_seq")
        assert dseq is not None, f"replan_push without decision_seq: {note}"
        chain = audit.chain(dseq)
        assert chain, f"decision_seq {dseq} not in the log"
        root, leaf = chain[0], chain[-1]
        assert leaf.seq == dseq and leaf.kind == "delta_replan", \
            f"push decision {dseq} is a {leaf.kind}, not a delta_replan"
        assert root.kind == "cluster_delta" \
            and root.cause in ("preemption", "spot_return"), \
            f"push decision {dseq} roots at {root.kind}/{root.cause!r}, " \
            "not the eviction/return cluster_delta"
        chains_verified += 1
    assert chains_verified == pushes

    # -- schema-valid, causally ordered event stream ----------------------
    evs = read_events_rotated(events_path)
    if events_max_bytes is not None:
        roll = events_path.with_name(events_path.name + ".1")
        assert roll.exists(), \
            f"events_max_bytes={events_max_bytes} never rotated the log " \
            f"({events_path.stat().st_size} bytes written)"
    problems = validate_events(evs)
    assert not problems, "event schema problems:\n  " + "\n  ".join(problems)
    tick_of = {}   # tick -> index of its fleet_tick event
    for i, e in enumerate(evs):
        if e["event"] == "fleet_tick":
            tick_of[e["tick"]] = i
    for i, e in enumerate(evs):
        if e["event"] in ("preemption", "spot_return"):
            # the eviction/return precedes the tick that absorbed it
            assert i < tick_of[e["step"]], \
                f"{e['event']} at tick {e['step']} logged after its " \
                "fleet_tick"
        if e["event"] == "recovery_cost":
            assert i < tick_of[e["tick"]], \
                "recovery_cost logged after its fleet_tick"
    # migration events are causally ordered within their tick:
    # reshard_plan -> reshard_step -> migration_complete, all before the
    # fleet_tick that absorbed the transition; a fallback precedes its tick
    mig_order = ("reshard_plan", "reshard_step", "migration_complete")
    per_tick: dict[int, list[str]] = {}
    for i, e in enumerate(evs):
        if e["event"] in mig_order + ("migration_fallback",):
            assert i < tick_of[e["step"]], \
                f"{e['event']} at tick {e['step']} logged after its " \
                "fleet_tick"
            per_tick.setdefault(e["step"], []).append(e["event"])
    for tick, names in per_tick.items():
        if names != ["migration_fallback"]:
            assert names == list(mig_order), \
                f"tick {tick}: migration events out of order: {names}"

    goodputs = [t["goodput_frac"] for t in trajectory]
    report = {
        "devices": devices,
        "ticks": ticks,
        "seed": seed,
        "spot_rate_per_hr": spot_rate_per_hr,
        "return_rate_per_hr": return_rate_per_hr,
        "preempted_nodes": preemptions,
        "returned_nodes": returns,
        "cluster_deltas": n_deltas,
        "replan_pushes": pushes,
        "migration_enabled": migrate,
        "migrations": migrations,
        "migration_fallbacks": fallbacks,
        "migration_stall_ms_total": round(migration_stall_ms_total, 3),
        "decision_records": n_recs,
        "provenance_chains_verified": chains_verified,
        "baseline_cost_ms": c0,
        "baseline_expected_recovery_ms": base_recovery_ms,
        "fleet_goodput_frac": sum(goodputs) / len(goodputs),
        "min_goodput_frac": min(goodputs),
        "trajectory": trajectory,
    }
    if (migrate and devices == 256 and ticks == 24 and seed == 0
            and spot_rate_per_hr == 0.05 and return_rate_per_hr == 0.35
            and spot_recover_s == 30.0 and tick_seconds == 3600.0):
        # the headline target at default scale: live migration must beat
        # the checkpoint-restore-only goodput of the same seeded chaos
        assert report["fleet_goodput_frac"] > 0.869, \
            f"default-scale goodput {report['fleet_goodput_frac']:.4f} " \
            "did not beat the checkpoint-restore baseline 0.869"
    if verbose:
        print(json.dumps({k: v for k, v in report.items()
                          if k != "trajectory"}, indent=2))
    return report


def run_tenant_drill(tmp_dir: str | Path, *, tenants: int = 3,
                     devices: int = 32, chips_per_node: int = 4,
                     ticks: int = 8, tick_seconds: float = 3600.0,
                     spot_rate_per_hr: float = 0.35,
                     return_rate_per_hr: float = 0.5,
                     spot_recover_s: float = 30.0, seed: int = 0,
                     verbose: bool = False) -> dict:
    """Multi-tenant preemption chaos against a live daemon's fleet
    scheduler.  Returns the tenant report dict; raises AssertionError
    when a quota or recovery guarantee is violated."""
    from metis_tpu_torch.inference.workload import InferenceWorkload
    from metis_tpu_torch.obs.decisions_schema import validate_file as validate_dlog
    from metis_tpu_torch.obs.provenance import DecisionLog
    from metis_tpu_torch.profiles.synthetic import synthesize_profiles
    from metis_tpu_torch.sched import TenantSpec
    from metis_tpu_torch.serve.client import PlanServiceClient
    from metis_tpu_torch.serve.daemon import PlanService, serve_in_thread

    assert tenants >= 3, "the multi-tenant drill needs >= 3 tenants"
    tmp_dir = Path(tmp_dir)
    tmp_dir.mkdir(parents=True, exist_ok=True)
    events_path = tmp_dir / "tenant_events.jsonl"
    decisions_path = tmp_dir / "tenant_decisions.jsonl"
    cluster = fleet_cluster(devices, chips_per_node, spot_rate_per_hr)
    n_reserved = sum(1 for n in cluster.nodes
                     if n.device_type == RESERVED_TYPE)
    n_spot = sum(1 for n in cluster.nodes if n.device_type == SPOT_TYPE)
    # floors: one node per training tenant, two for the inference tenant
    # (disaggregated serving needs separate prefill/decode pools); the
    # reserved pool alone must cover the floors so no Poisson eviction
    # pattern can over-commit them
    floor_nodes = tenants + 1
    assert floor_nodes <= n_reserved, \
        f"{tenants} tenants need {floor_nodes} reserved nodes of quota " \
        f"floor, fleet has {n_reserved} — raise --devices"
    model = tenant_model()
    profiles = synthesize_profiles(model, [RESERVED_TYPE, SPOT_TYPE],
                                   tps=[1, 2, 4], bss=[1, 2, 4, 8])
    floor = chips_per_node
    base_cfg = SearchConfig(gbs=32, max_profiled_tp=4, max_profiled_bs=8,
                            use_spot_model=True,
                            spot_recover_s=spot_recover_s)
    # the inference tenant is registered at its diurnal peak (the carve
    # must handle the worst tick); attainment compares the carve's
    # throughput against each tick's raised-cosine demand
    peak_rps = 2.0
    workload = InferenceWorkload(
        arrival_rate_rps=peak_rps, prompt_len=256, output_len=64,
        slo_ttft_p99_ms=4000.0, slo_tpot_p99_ms=200.0)
    specs = [
        TenantSpec("train-hi", model, base_cfg, priority=2,
                   quota_floor=floor),
        TenantSpec("serve-web", model, base_cfg, priority=1,
                   quota_floor=2 * floor, workload=workload),
        TenantSpec("train-lo", model,
                   dataclasses.replace(base_cfg, gbs=16), priority=0,
                   quota_floor=floor),
    ]
    for i in range(3, tenants):
        specs.append(TenantSpec(
            f"train-x{i}", model, dataclasses.replace(base_cfg, gbs=16),
            priority=0, quota_floor=floor))
    floors = {s.name: s.quota_floor for s in specs}

    def _diurnal(tick: int) -> float:
        phase = 2.0 * math.pi * tick / max(ticks, 1)
        return peak_rps * (0.35 + 0.325 * (1.0 - math.cos(phase)))

    def _strip(resp: dict) -> dict:
        # drop the per-request fields (cached/serve_ms) so the closing
        # byte-identity compares fleet state, not cache temperature
        return {k: resp[k] for k in
                ("fingerprint", "tenant", "kind", "devices",
                 "node_indices", "feasible", "plans", "utility",
                 "utility_frac")}

    rng = random.Random(seed)
    hours = tick_seconds / 3600.0
    p_evict = 1.0 - math.exp(-spot_rate_per_hr * hours)
    p_return = 1.0 - math.exp(-return_rate_per_hr * hours)

    trajectory: list[dict] = []
    attained = {s.name: 0 for s in specs}
    utils: list[float] = []
    with EventLog(events_path) as events:
        service = PlanService(cluster, profiles, events=events,
                              decisions=DecisionLog(decisions_path,
                                                    events=events))
        server, thread, address = serve_in_thread(service)
        try:
            client = PlanServiceClient(address)
            for s in specs:
                resp = client.tenant_register(s)
                assert resp["feasible"], \
                    f"tenant {s.name} admitted infeasible on the " \
                    "healthy fleet"

            def _fleet_state() -> str:
                status = client.tenant_status()
                plans = {s.name: _strip(client.tenant_plan(s.name))
                         for s in specs}
                return json.dumps({"status": status, "plans": plans},
                                  sort_keys=True)

            baseline = _fleet_state()
            live_spot = n_spot
            n_deltas = preemptions = returns = 0
            # final drain tick returns every evicted node: the closing
            # fleet state must be byte-identical to the baseline
            for tick in range(ticks + 1):
                lost_nodes = returned_nodes = 0
                if tick < ticks:
                    for _ in range(live_spot):
                        if rng.random() < p_evict:
                            lost_nodes += 1
                    for _ in range(n_spot - live_spot):
                        if rng.random() < p_return:
                            returned_nodes += 1
                else:
                    returned_nodes = n_spot - live_spot
                if lost_nodes:
                    lost = {SPOT_TYPE: lost_nodes * chips_per_node}
                    events.emit("preemption", step=tick, tier="spot",
                                lost=f"{SPOT_TYPE}={lost[SPOT_TYPE]}")
                    client.cluster_delta(removed=lost, cause="preemption")
                    live_spot -= lost_nodes
                    n_deltas += 1
                    preemptions += lost_nodes
                if returned_nodes:
                    back = {SPOT_TYPE: returned_nodes * chips_per_node}
                    events.emit("spot_return", step=tick,
                                returned=f"{SPOT_TYPE}={back[SPOT_TYPE]}")
                    client.cluster_delta(added=back, cause="spot_return")
                    live_spot += returned_nodes
                    n_deltas += 1
                    returns += returned_nodes

                status = client.tenant_status()
                allocs = {a["tenant"]: a for a in status["allocations"]}
                for s in specs:
                    a = allocs.get(s.name)
                    assert a is not None and a["feasible"], \
                        f"tick {tick}: tenant {s.name} has no valid plan"
                    assert a["devices"] >= floors[s.name], \
                        f"tick {tick}: tenant {s.name} below quota " \
                        f"floor ({a['devices']} < {floors[s.name]})"
                demand = _diurnal(tick)
                for s in specs:
                    if s.workload is None:
                        ok = allocs[s.name]["feasible"]
                    else:
                        served = client.tenant_plan(s.name)
                        ok = (served["feasible"]
                              and served["utility"] >= demand)
                    attained[s.name] += 1 if ok else 0
                util = status["utilization_frac"]
                utils.append(util)
                n_devices = status["cluster_devices"]
                events.emit("fleet_tick", tick=tick, devices=n_devices,
                            goodput_frac=round(util, 6))
                trajectory.append({
                    "tick": tick, "devices": n_devices,
                    "utilization_frac": util,
                    "demand_rps": round(demand, 4),
                    "lost_nodes": lost_nodes,
                    "returned_nodes": returned_nodes,
                })
            closing = _fleet_state()
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)

    # -- the drill's guarantees -------------------------------------------
    assert preemptions > 0, \
        "seeded chaos produced no evictions — raise --ticks or --spot-rate"
    assert trajectory[-1]["devices"] == devices, \
        "fleet did not drain back to full capacity"
    assert closing == baseline, \
        "closing fleet state diverged from the pre-chaos baseline"

    # -- schema-valid, causally ordered event stream ----------------------
    evs = read_events(events_path)
    problems = validate_events(evs)
    assert not problems, "event schema problems:\n  " + "\n  ".join(problems)
    names = [e["event"] for e in evs]
    admits = [i for i, e in enumerate(evs) if e["event"] == "tenant_admit"]
    assert len(admits) == tenants, \
        f"expected {tenants} tenant_admit events, saw {len(admits)}"
    first_cap = next((i for i, e in enumerate(evs)
                      if e["event"] in ("preemption", "spot_return")),
                     len(evs))
    assert max(admits) < first_cap, "a tenant_admit logged after chaos began"
    n_preempt_events = names.count("tenant_preempt")
    assert n_preempt_events > 0, \
        "spot evictions never preempted a tenant's carve"
    for i, e in enumerate(evs):
        if e["event"] != "tenant_preempt":
            continue
        prior_cap = [j for j in range(i) if evs[j]["event"]
                     in ("preemption", "spot_return")]
        assert prior_cap, "tenant_preempt with no prior capacity change"
        assert any(evs[j]["event"] == "fleet_objective"
                   for j in range(prior_cap[-1], i)), \
            "tenant_preempt not preceded by its re-partition's " \
            "fleet_objective"
        assert any(evs[j]["event"] == "tenant_replan"
                   and evs[j]["tenant"] == e["tenant"]
                   for j in range(i + 1, len(evs))), \
            f"preempted tenant {e['tenant']} was never replanned"
        assert e["to_devices"] >= floors[e["tenant"]], \
            f"tenant_preempt drove {e['tenant']} below its quota floor"

    # -- provenance: `why --tenant` reconstructs the chain -----------------
    # Drive the REAL CLI over the on-disk decision log (the daemon is
    # down): for every tenant that a spot eviction preempted, the causal
    # chain from its served plan must walk back to the eviction/return
    # cluster_delta that triggered it.
    n_recs, dlog_problems = validate_dlog(decisions_path)
    assert not dlog_problems, \
        "decision log problems:\n  " + "\n  ".join(dlog_problems)
    from metis_tpu_torch.cli import main as cli_main

    preempted = sorted({e["tenant"] for e in evs
                        if e["event"] == "tenant_preempt"})
    why_depths: dict[str, int] = {}
    for name in preempted:
        out_path = tmp_dir / f"why_{name}.json"
        rc = cli_main(["why", "--tenant", name,
                       "--decisions", str(decisions_path),
                       "--json", "--output", str(out_path)])
        assert rc == 0, f"why --tenant {name} failed (rc {rc})"
        why = json.loads(out_path.read_text())
        hops = [h["record"] for h in why["hops"]]
        assert why["depth"] >= 2 and hops, \
            f"why --tenant {name}: no causal chain ({why['depth']} hops)"
        root, leaf = hops[0], hops[-1]
        assert leaf.get("tenant") == name, \
            f"why --tenant {name} resolved a record for " \
            f"{leaf.get('tenant')!r}"
        assert root["kind"] == "cluster_delta" \
            and root.get("cause") in ("preemption", "spot_return"), \
            f"why --tenant {name} roots at {root['kind']}/" \
            f"{root.get('cause')!r}, not the eviction/return delta"
        why_depths[name] = why["depth"]

    slo = {name: attained[name] / (ticks + 1) for name in attained}
    report = {
        "tenants": [s.name for s in specs],
        "devices": devices,
        "ticks": ticks,
        "seed": seed,
        "spot_rate_per_hr": spot_rate_per_hr,
        "return_rate_per_hr": return_rate_per_hr,
        "preempted_nodes": preemptions,
        "returned_nodes": returns,
        "cluster_deltas": n_deltas,
        "tenant_preempt_events": n_preempt_events,
        "decision_records": n_recs,
        "why_chain_depths": why_depths,
        "fleet_utilization_frac": sum(utils) / len(utils),
        "min_utilization_frac": min(utils),
        "tenant_slo_attainment": slo,
        "tenant_slo_attainment_min": min(slo.values()),
        "closing_state_identical": True,
        "trajectory": trajectory,
    }
    if verbose:
        print(json.dumps({k: v for k, v in report.items()
                          if k != "trajectory"}, indent=2))
    return report


def drill_model() -> ModelSpec:
    """The reference drill's model (``tools/chaos_drill.py``), tiny enough
    to train in seconds.  Its attention is the default dense one: its head
    dim of 16 is below the flash kernels' (64, 128), and the reference's
    drill trains it dense too."""
    return ModelSpec(name="gpt-drill", num_layers=4, hidden_size=32,
                     sequence_length=16, vocab_size=128, num_heads=2)


def drill_setup(gbs: int = 8):
    """(cluster, profiles, model, search_config) of the reference's canned
    drill: 2 nodes x 4 A100 — losing a node leaves a plannable 4-device
    survivor topology."""
    from metis_tpu_torch.profiles.synthetic import synthesize_profiles

    model = drill_model()
    cluster = ClusterSpec.of(("A100", 2, 4))
    profiles = synthesize_profiles(model, ["A100"], tps=[1, 2, 4],
                                   bss=[1, 2, 4, 8])
    config = SearchConfig(gbs=gbs, max_profiled_tp=4, max_profiled_bs=8)
    return cluster, profiles, model, config


SPOT_SCRIPT = "spot_preemption@3:A100=4,spot_return@5"


def run_supervisor_spot_drill(tmp_dir: str | Path, steps: int = 8, *,
                              device: str = "cuda", pool=None,
                              init=0) -> dict:
    """Scripted spot eviction + return under the training supervisor:
    shrink -> replan -> restore, then grow -> replan, causally ordered.

    The port's supervisor runs one rank per device of the cluster, so the
    drill's 2 x 4 A100 are eight gloo ranks: on ``device`` (the card,
    shared by all eight, or the CPU when the caller asks for it), or on
    ``pool`` (an ``execution.dist.RankPool`` of eight gloo ranks).
    ``init``: the seed, or the full parameter tree, of the fresh state."""
    from metis_tpu_torch.core.config import ResilienceConfig
    from metis_tpu_torch.core.device import resolve_device
    from metis_tpu_torch.execution import dist
    from metis_tpu_torch.resilience.supervisor import supervised_rank

    dev = resolve_device(device) if pool is None else None  # a missing card fails first
    tmp_dir = Path(tmp_dir)
    events_path = tmp_dir / "spot_events.jsonl"
    cluster, profiles, model, config = drill_setup()
    full_devices = cluster.total_devices
    profiles.dump_to_dir(tmp_dir / "spot-profiles")
    job = dict(
        cluster=cluster, profile_dir=str(tmp_dir / "spot-profiles"),
        model=model, config=config,
        resilience=ResilienceConfig(checkpoint_every=2, retry_attempts=3),
        fault_script=SPOT_SCRIPT, seed=0,
        checkpoint_dir=str(tmp_dir / "spot-ckpt"), steps=steps,
        events=str(events_path), no_sleep=True, init=init)
    if pool is None:
        ranks = dist.spawn(supervised_rank, full_devices, "gloo",
                           [dev] * full_devices, job)
    else:
        ranks = pool.run(supervised_rank, job)
    out = ranks[0]

    rep = out["report"]
    assert rep["outcome"] == "completed", \
        f"spot drill did not complete: {rep['outcome']} ({rep['detail']})"
    assert rep["steps_done"] == steps
    kinds = [r["kind"] for r in rep["recoveries"]]
    assert kinds == ["spot_preemption", "spot_return"], \
        f"expected eviction then return recoveries, got {kinds}"
    assert all(r["report"] == rep for r in ranks), \
        "the ranks' reports differ"
    assert out["total_devices"] == full_devices, \
        "returned capacity was not grown back into the cluster"

    evs = read_events(events_path)
    problems = validate_events(evs)
    assert not problems, "event schema problems:\n  " + "\n  ".join(problems)
    names = [e["event"] for e in evs]
    recs = [i for i, n in enumerate(names) if n == "recovery_complete"]
    assert len(recs) == 2, f"expected 2 recoveries, saw {len(recs)}"
    assert names.index("preemption") < recs[0] \
        < names.index("spot_return") < recs[1], \
        "preemption -> recovery -> spot_return -> recovery out of order"
    pre = next(e for e in evs if e["event"] == "preemption")
    assert pre["tier"] == "spot" and pre["lost"] == "A100=4"
    ret = next(e for e in evs if e["event"] == "spot_return")
    assert ret["returned"] == "A100=4"
    return rep


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tenants", type=int, default=0, metavar="N",
                   help="run the multi-tenant scheduler drill with N "
                        "tenants instead of the single-job fleet legs")
    p.add_argument("--devices", type=int, default=None,
                   help="fleet size, half reserved v6e + half spot v5e "
                        "(default: 256, or 32 with --tenants)")
    p.add_argument("--chips-per-node", type=int, default=None,
                   help="(default: 32, or 4 with --tenants)")
    p.add_argument("--ticks", type=int, default=None,
                   help="(default: 24, or 8 with --tenants)")
    p.add_argument("--tick-seconds", type=float, default=3600.0)
    p.add_argument("--spot-rate", type=float, default=None,
                   help="per-node spot preemption rate (events/hr; "
                        "default: 0.05, or 0.35 with --tenants)")
    p.add_argument("--return-rate", type=float, default=None,
                   help="per-evicted-node return rate (events/hr; "
                        "default: 0.35, or 0.5 with --tenants)")
    p.add_argument("--spot-recover-s", type=float, default=30.0)
    p.add_argument("--no-migrate", action="store_true",
                   help="checkpoint-restore-only accounting (every delta "
                        "charged --spot-recover-s)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=8,
                   help="training steps for the supervisor leg")
    p.add_argument("--skip-supervisor", action="store_true",
                   help="fleet simulation only (the supervisor leg trains "
                        "a real model on eight ranks and dominates wall "
                        "time)")
    p.add_argument("--device", default="cuda",
                   help="where the supervisor leg's eight ranks train: the "
                        "card, shared (default), or 'cpu'")
    p.add_argument("--keep", default=None, metavar="DIR",
                   help="run in DIR and keep the artifacts (default: a "
                        "temp dir, removed afterwards)")
    p.add_argument("--report", default=None, metavar="PATH",
                   help="also write the drill reports as JSON to PATH")
    args = p.parse_args(argv)

    # the two legs run at different natural scales: the single-job fleet
    # simulation is a 256-device pool, the multi-tenant leg pays one
    # planner search per tenant sub-cluster per re-partition candidate
    tenant_mode = args.tenants > 0
    if not (tenant_mode or args.skip_supervisor):
        from metis_tpu_torch.core.device import resolve_device

        resolve_device(args.device)  # a missing card fails before the drill
    devices = args.devices if args.devices is not None \
        else (32 if tenant_mode else 256)
    chips_per_node = args.chips_per_node if args.chips_per_node is not None \
        else (4 if tenant_mode else 32)
    ticks = args.ticks if args.ticks is not None \
        else (8 if tenant_mode else 24)
    spot_rate = args.spot_rate if args.spot_rate is not None \
        else (0.35 if tenant_mode else 0.05)
    return_rate = args.return_rate if args.return_rate is not None \
        else (0.5 if tenant_mode else 0.35)

    def _run_tenants(d: str) -> None:
        rep = run_tenant_drill(
            d, tenants=args.tenants, devices=devices,
            chips_per_node=chips_per_node, ticks=ticks,
            tick_seconds=args.tick_seconds, spot_rate_per_hr=spot_rate,
            return_rate_per_hr=return_rate,
            spot_recover_s=args.spot_recover_s, seed=args.seed,
            verbose=True)
        print(f"tenant drill OK: {len(rep['tenants'])} tenants, "
              f"{rep['preempted_nodes']} evictions, utilization "
              f"{rep['fleet_utilization_frac']:.4f}, min SLO attainment "
              f"{rep['tenant_slo_attainment_min']:.4f}")
        if args.report:
            Path(args.report).write_text(json.dumps({"tenants": rep}))

    def _run(d: str) -> None:
        if tenant_mode:
            _run_tenants(d)
            return
        rep = run_fleet_drill(
            d, devices=devices, chips_per_node=chips_per_node,
            ticks=ticks, tick_seconds=args.tick_seconds,
            spot_rate_per_hr=spot_rate,
            return_rate_per_hr=return_rate,
            spot_recover_s=args.spot_recover_s, seed=args.seed,
            migrate=not args.no_migrate, verbose=True)
        print(f"fleet drill OK: {rep['preempted_nodes']} evictions, "
              f"{rep['returned_nodes']} returns, goodput "
              f"{rep['fleet_goodput_frac']:.4f}")
        if rep["migration_enabled"]:
            print(f"  live migration: {rep['migrations']} migrations "
                  f"({rep['migration_stall_ms_total']:.1f} ms stalled), "
                  f"{rep['migration_fallbacks']} fault-driven fallback(s)")
        sup = None
        if not args.skip_supervisor:
            sup = run_supervisor_spot_drill(d, steps=args.steps,
                                            device=args.device)
            print(f"supervisor spot drill OK: {sup['steps_done']} steps, "
                  f"{len(sup['recoveries'])} recoveries")
        if args.report:
            Path(args.report).write_text(
                json.dumps({"fleet": rep, "supervisor": sup}))

    if args.keep:
        Path(args.keep).mkdir(parents=True, exist_ok=True)
        _run(args.keep)
    else:
        with tempfile.TemporaryDirectory(prefix="fleet-drill-") as d:
            _run(d)
    return 0
