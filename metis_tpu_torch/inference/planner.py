"""Disaggregated prefill/decode plan search under p99 latency SLOs.

The port's copy of ``metis_tpu/inference/planner.py``: the same ranking, the
same dump bytes.

The search space is: (1) a node-granularity split of the cluster into a
prefill pool and a decode pool (every per-type node count combination with
both pools non-empty); (2) per pool, the SAME inter-stage enumeration the
training planner walks (``search/inter_stage.py`` with gbs=1 — serving has
no gradient microbatching) crossed with the data-parallel lane counts that
divide every stage's device group; (3) per candidate, a uniform layer
partition (serving has no per-stage activation-memory pressure to balance
against — KV dominates, and the KV check below is per-stage anyway).

Pricing: prefill lanes are M/D/c servers (deterministic service = the
pipeline's forward latency) under Poisson arrivals — Erlang-C gives the
wait probability, and the p99 wait uses the exponential tail of the M/M/c
delay distribution halved (the classic ~2x mean-wait advantage of
deterministic service).  Decode steps race per-token compute against the
HBM roofline of re-reading stage weights + KV every token; the per-stage
excess of memory over compute is reported as the ``kv_read`` component.
Max concurrency per lane falls out of the KV-vs-HBM-capacity check
(``balance.stage_perf.max_kv_concurrency``), and TPOT is monotone in the
batch, so the best batch is the largest KV-feasible one still inside the
TPOT SLO.

Ranking: SLO-feasible plans first, then max sustainable throughput, then
lower TTFT, then lower TPOT — deterministic, pinned by the frozen golden in
``tools/check_search_regression.py``.
"""
from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass
from itertools import product

from metis_tpu_torch.balance.stage_perf import max_kv_concurrency, rank_device_types
from metis_tpu_torch.cluster.spec import ClusterSpec
from metis_tpu_torch.core.config import ModelSpec, SearchConfig
from metis_tpu_torch.core.errors import KvCacheOomError, MetisError, ProfileMissError
from metis_tpu_torch.core.events import NULL_LOG, EventLog
from metis_tpu_torch.core.types import InferenceCostBreakdown, divisors
from metis_tpu_torch.cost.estimator import (
    paged_kv_seq_bytes,
    shared_prefix_stage_bytes,
    uniform_layer_split,
)
from metis_tpu_torch.inference.workload import (
    InferenceWorkload,
    decode_compute_stage_ms,
    hbm_read_ms,
    measured_decode_stage_ms,
    prefill_stage_ms,
)
from metis_tpu_torch.profiles.store import ProfileStore
from metis_tpu_torch.search.inter_stage import inter_stage_plans

# Concurrency clamp for stages that hold no KV (embed/head-only): keeps the
# best-batch binary search bounded without ever being the binding limit.
_B_CLAMP = 1 << 20


@dataclass(frozen=True)
class PoolPlan:
    """One pool's placement: the training inter-stage shape plus the serving
    lane structure (dp lanes × per-stage tp) and the pool's own headline
    metric (``max_rps``: queue-capacity for prefill, generation throughput
    for decode)."""

    role: str  # "prefill" | "decode"
    node_counts: dict[str, int]  # nodes per device type in this pool
    node_sequence: tuple[str, ...]
    device_groups: tuple[int, ...]
    dp: int
    tp_per_stage: tuple[int, ...]
    layer_partition: tuple[int, ...]
    num_devices: int
    max_rps: float
    latency_ms: float  # prefill: pipeline forward latency; decode: TPOT
    batch_per_lane: int = 0  # decode only: chosen concurrency per lane
    # decode only: "measured" when TPOT came from the profile's decode table,
    # "derived" when a table exists but lacked this pool's (type, tp) points
    # and the forward-share derivation priced it.  "" (pre-decode-table
    # stores) is omitted from the dump so the serving golden's bytes hold.
    decode_source: str = ""

    def to_json_dict(self) -> dict:
        d = {
            "role": self.role,
            "node_counts": {t: self.node_counts[t]
                            for t in sorted(self.node_counts)},
            "node_sequence": list(self.node_sequence),
            "device_groups": list(self.device_groups),
            "dp": self.dp,
            "tp_per_stage": list(self.tp_per_stage),
            "layer_partition": list(self.layer_partition),
            "num_devices": self.num_devices,
            "max_rps": self.max_rps,
            "latency_ms": self.latency_ms,
            "batch_per_lane": self.batch_per_lane,
        }
        if self.decode_source:
            d["decode_source"] = self.decode_source
        return d


@dataclass(frozen=True)
class RankedInferencePlan:
    prefill: PoolPlan
    decode: PoolPlan
    cost: InferenceCostBreakdown

    def to_json_dict(self) -> dict:
        return {
            "prefill": self.prefill.to_json_dict(),
            "decode": self.decode.to_json_dict(),
            "cost": self.cost.to_json_dict(),
        }


@dataclass(frozen=True)
class InferencePlannerResult:
    plans: tuple[RankedInferencePlan, ...]
    num_costed: int
    num_pruned: int
    num_splits: int

    @property
    def best(self) -> RankedInferencePlan | None:
        return self.plans[0] if self.plans else None


def fingerprint_inference_plan(plan: RankedInferencePlan | None) -> str | None:
    """12-hex identity of one ranked serving plan's placement + cost —
    the serve daemon's ``plan_fingerprint`` for inference entries (the
    training counterpart is ``obs.ledger.fingerprint_ranked_plan``)."""
    if plan is None:
        return None
    payload = json.dumps(plan.to_json_dict(), sort_keys=True,
                         separators=(",", ":"))
    return hashlib.sha1(payload.encode()).hexdigest()[:12]


def dump_inference_plans(result: InferencePlannerResult,
                         workload: InferenceWorkload | None = None) -> str:
    """Deterministic JSON of a ranked inference search — the serve daemon's
    response body and the frozen-golden subject (byte-identical across
    processes for identical inputs)."""
    payload = {
        "workload": workload.to_json_dict() if workload else None,
        "num_costed": result.num_costed,
        "num_pruned": result.num_pruned,
        "num_splits": result.num_splits,
        "plans": [{"rank": i + 1, **p.to_json_dict()}
                  for i, p in enumerate(result.plans)],
    }
    return json.dumps(payload, indent=2)


# -- queueing ---------------------------------------------------------------

def erlang_c(c: int, offered_load: float) -> float:
    """P(wait > 0) for an M/M/c queue at offered load a = λ/μ erlangs,
    via the numerically stable inverted Erlang-B recursion."""
    if offered_load <= 0:
        return 0.0
    if offered_load >= c:
        return 1.0
    inv_b = 1.0
    for k in range(1, c + 1):
        inv_b = 1.0 + inv_b * k / offered_load
    b = 1.0 / inv_b
    rho = offered_load / c
    return b / (1.0 - rho + rho * b)


def queue_wait_p99_ms(arrival_rps: float, lanes: int,
                      service_ms: float) -> float:
    """p99 queue wait for Poisson arrivals on ``lanes`` deterministic
    servers: the M/M/c conditional wait is exponential with rate
    ``c·μ − λ``, so ``P(W > t) = C·exp(-(cμ-λ)t)``; deterministic service
    halves the wait (M/D/c ≈ M/M/c / 2)."""
    lam = arrival_rps / 1000.0  # per ms
    mu = 1.0 / service_ms
    if lam >= lanes * mu:
        return math.inf
    c_prob = erlang_c(lanes, lam / mu)
    if c_prob <= 0.01:
        return 0.0
    return math.log(c_prob / 0.01) / (lanes * mu - lam) / 2.0


def max_rps_under_wait(lanes: int, service_ms: float,
                       wait_budget_ms: float) -> float:
    """Largest Poisson arrival rate whose p99 wait stays inside the budget
    (fixed-iteration bisection on (0, c·μ) — wait is monotone in λ)."""
    if wait_budget_ms < 0:
        return 0.0
    hi = lanes * 1000.0 / service_ms
    lo = 0.0
    for _ in range(60):
        mid = (lo + hi) / 2.0
        if queue_wait_p99_ms(mid, lanes, service_ms) <= wait_budget_ms:
            lo = mid
        else:
            hi = mid
    return lo


# -- pool enumeration -------------------------------------------------------

def pool_splits(cluster: ClusterSpec):
    """Every node-granularity prefill/decode split: per device type, the
    prefill pool takes the FIRST k nodes of that type (0..all), the decode
    pool the rest; both pools must be non-empty.  Yields the per-type
    prefill node counts in deterministic (node-order types, ascending
    count) order."""
    types = cluster.device_types
    node_counts = {t: sum(1 for n in cluster.nodes if n.device_type == t)
                   for t in types}
    for combo in product(*(range(node_counts[t] + 1) for t in types)):
        if all(k == 0 for k in combo):
            continue
        if all(k == node_counts[t] for t, k in zip(types, combo)):
            continue
        yield dict(zip(types, combo))


def split_cluster(cluster: ClusterSpec,
                  prefill_counts: dict[str, int]) -> tuple[ClusterSpec, ClusterSpec]:
    """Materialize one split as two ClusterSpecs (device dict restricted to
    each pool's member types so pool enumeration never permutes absent
    types)."""
    taken = dict(prefill_counts)
    pre, dec = [], []
    for node in cluster.nodes:
        if taken.get(node.device_type, 0) > 0:
            taken[node.device_type] -= 1
            pre.append(node)
        else:
            dec.append(node)

    def mk(nodes):
        devs = {t: cluster.devices[t] for t in {n.device_type for n in nodes}}
        return ClusterSpec(nodes=tuple(nodes), devices=devs)

    return mk(pre), mk(dec)


def _layer_offsets(model: ModelSpec, num_stages: int) -> list[tuple[int, int]]:
    counts = uniform_layer_split(model.num_layers, num_stages)
    out, acc = [], 0
    for c in counts:
        out.append((acc, acc + c))
        acc += c
    return out


def _pool_candidates(pool: ClusterSpec, model: ModelSpec,
                     config: SearchConfig):
    """(inter_plan, dp, per-stage tp) candidates for one pool: the training
    inter-stage space at gbs=1 × every dp that divides all device groups."""
    for inter in inter_stage_plans(
            pool.device_types, pool.total_devices, 1, model.num_layers,
            variance=config.min_group_scale_variance,
            max_permute_len=config.max_permute_len):
        g = math.gcd(*inter.device_groups)
        for dp in divisors(g):
            tps = tuple(gs // dp for gs in inter.device_groups)
            if max(tps) > config.max_profiled_tp:
                continue
            yield inter, dp, tps


# -- per-pool pricing -------------------------------------------------------

def _price_prefill(pool, profiles, model, config, workload, inter, dp, tps):
    """(compute_ms, send_ms) of one prompt through a prefill candidate, or
    ProfileMissError when a stage's (type, tp, bs=1) is unprofiled."""
    ranks = rank_device_types(pool, inter.node_sequence)
    offsets = _layer_offsets(model, inter.num_stages)
    compute_ms = 0.0
    for s, (lo, hi) in enumerate(offsets):
        r0, r1 = inter.stage_rank_range(s)
        compute_ms += max(
            prefill_stage_ms(profiles, model, t, tps[s], lo, hi,
                             workload.tail_prompt_len)
            for t in set(ranks[r0:r1]))
    send_ms = 0.0
    if inter.num_stages > 1:
        bw = pool.inter_bw_for_types(pool.device_types)
        send_ms = ((inter.num_stages - 1) * model.hidden_size
                   * workload.tail_prompt_len * model.dtype_bytes
                   / (bw * 1e6))
    return compute_ms, send_ms


def _price_decode(pool, profiles, model, config, workload, inter, dp, tps):
    """Decode-side pricing of one candidate.

    Returns ``(batch, tpot_ms, (compute_ms, kv_read_ms, comm_ms), rps,
    decode_source)`` at the best KV-feasible batch inside the TPOT SLO, or
    raises ProfileMissError / KvCacheOomError for the caller to prune on.

    Compute rates come from the profile's MEASURED decode table when every
    (type, tp) this candidate touches carries one (``decode_source ==
    "measured"``); a store with no decode table at all prices from the
    training forward share, as before decode tables existed (``decode_source == ""``,
    omitted from dumps); a table with partial coverage falls back to the
    derivation for the WHOLE candidate (``"derived"``) — mixing pricing
    models across stages of one pipeline would make stage sums meaningless.

    KV bytes use the paged prefix-sharing model: each lane keeps one copy of
    the shared-prefix pages (``shared``) plus per-sequence unique pages
    (``kv_per_seq``); the HBM roofline reads the shared pages once per step
    (cascade attention) rather than once per sequence."""
    ranks = rank_device_types(pool, inter.node_sequence)
    offsets = _layer_offsets(model, inter.num_stages)
    context = workload.max_context_len
    pfx = workload.shared_prefix_len
    params = profiles.model.params_per_layer_bytes
    stages = []  # (lo, hi, tp, types, weights_per_rank, kv_per_seq, shared, hbm)
    b_max = _B_CLAMP
    for s, (lo, hi) in enumerate(offsets):
        r0, r1 = inter.stage_rank_range(s)
        types = sorted(set(ranks[r0:r1]))
        tp = tps[s]
        weights_per_rank = sum(params[lo:hi]) / tp
        kv_per_seq = paged_kv_seq_bytes(
            model, context, lo, hi, workload.kv_dtype_bytes, tp,
            page_tokens=workload.page_tokens, prefix_len=pfx,
            prefix_share_frac=workload.prefix_share_frac)
        shared = shared_prefix_stage_bytes(
            model, pfx, context, lo, hi, workload.kv_dtype_bytes, tp,
            page_tokens=workload.page_tokens,
            prefix_share_frac=workload.prefix_share_frac)
        cap_mb = min(pool.memory_mb(t) for t in types)
        b_max = min(b_max, max_kv_concurrency(
            cap_mb, weights_per_rank, kv_per_seq, stage=s,
            shared_bytes=shared))
        stages.append((lo, hi, tp, types, weights_per_rank, kv_per_seq,
                       shared,
                       min(pool.devices[t].effective_hbm_gbps
                           for t in types)))
    if b_max < 1:
        # weights fit (max_kv_concurrency did not raise) but the headroom
        # holds no whole sequence — prune, distinct from the OOM case
        raise _PruneBatch("KV headroom below one sequence")
    decode_source = ""
    comp_rates = None
    if profiles.has_decode():
        measured = [
            [measured_decode_stage_ms(profiles, t, tp, lo, hi, 1,
                                      config.max_profiled_bs)
             for t in types]
            for lo, hi, tp, types, *_ in stages]
        if all(m is not None for ms in measured for m in ms):
            decode_source = "measured"
            comp_rates = [max(ms) for ms in measured]
        else:
            decode_source = "derived"
    if comp_rates is None:
        comp_rates = [
            max(decode_compute_stage_ms(profiles, model, t, tp, lo, hi, 1,
                                        config.max_profiled_bs)
                for t in types)
            for lo, hi, tp, types, *_ in stages]
    stage_info = [(rate, w, kvps, shared, hbm)
                  for rate, (_, _, _, _, w, kvps, shared, hbm)
                  in zip(comp_rates, stages)]
    send_per_seq = 0.0
    if inter.num_stages > 1:
        bw = pool.inter_bw_for_types(pool.device_types)
        send_per_seq = model.hidden_size * model.dtype_bytes / (bw * 1e6)

    def step(batch):
        comp_sum = kv_excess = 0.0
        for comp_rate, w, kvps, shared, hbm in stage_info:
            comp = comp_rate * batch
            mem = hbm_read_ms(w + shared + kvps * batch, hbm)
            comp_sum += comp
            kv_excess += max(0.0, mem - comp)
        comm = (inter.num_stages - 1) * send_per_seq * batch
        return comp_sum + kv_excess + comm, (comp_sum, kv_excess, comm)

    # TPOT is nondecreasing and per-lane throughput B/tpot(B) increasing in
    # B (affine step with positive weight-read intercept), so the best batch
    # is the largest SLO-feasible one.
    lo_b, hi_b = 1, b_max
    if step(1)[0] > workload.slo_tpot_p99_ms:
        best_b = 1  # nothing meets TPOT; report the fastest step, slo_ok=False
    else:
        while lo_b < hi_b:
            mid = (lo_b + hi_b + 1) // 2
            if step(mid)[0] <= workload.slo_tpot_p99_ms:
                lo_b = mid
            else:
                hi_b = mid - 1
        best_b = lo_b
    tpot_ms, parts = step(best_b)
    tokens_per_s = dp * best_b * 1000.0 / tpot_ms
    rps = tokens_per_s / workload.output_len
    return best_b, tpot_ms, parts, rps, decode_source


class _PruneBatch(MetisError):
    """Internal: KV headroom fits weights but not one sequence — the
    candidate is pruned (distinct from KvCacheOomError, which means the
    weights themselves do not fit)."""


# -- search -----------------------------------------------------------------

def plan_inference(
    cluster: ClusterSpec,
    profiles: ProfileStore,
    model: ModelSpec,
    config: SearchConfig,
    workload: InferenceWorkload,
    top_k: int = 20,
    events: EventLog = NULL_LOG,
) -> InferencePlannerResult:
    """Rank disaggregated serving plans for ``workload`` on ``cluster``.

    One ranked plan per pool split: the split's best prefill candidate
    (max queue-capacity rps under the TTFT budget) paired with its best
    decode candidate (max generation rps under the TPOT SLO).  Splits where
    a pool has no feasible candidate are dropped (counted in
    ``num_pruned``)."""
    # prompt KV handoff crosses pools on the slowest inter-node link present;
    # a shared prefix's pages are already resident on the decode pool
    # (transferred once, amortized to ~0 per request), so the expected
    # per-request transfer is the unique-page bytes under the paged model —
    # identical to the full prompt when sharing is off
    handoff_bw = cluster.inter_bw_for_types(cluster.device_types)
    handoff_ms = hbm_read_ms(
        paged_kv_seq_bytes(model, workload.tail_prompt_len, 0,
                           model.num_layers, workload.kv_dtype_bytes, 1,
                           page_tokens=workload.page_tokens,
                           prefix_len=workload.shared_prefix_len,
                           prefix_share_frac=workload.prefix_share_frac),
        handoff_bw)

    num_costed = num_pruned = num_splits = 0
    ranked: list[tuple[tuple, RankedInferencePlan]] = []
    for prefill_counts in pool_splits(cluster):
        num_splits += 1
        pre_pool, dec_pool = split_cluster(cluster, prefill_counts)

        best_pre = None  # (key, PoolPlan, compute_ms, send_ms)
        for inter, dp, tps in _pool_candidates(pre_pool, model, config):
            try:
                compute_ms, send_ms = _price_prefill(
                    pre_pool, profiles, model, config, workload,
                    inter, dp, tps)
            except ProfileMissError:
                num_pruned += 1
                continue
            num_costed += 1
            latency = compute_ms + send_ms
            budget = workload.slo_ttft_p99_ms - latency - handoff_ms
            cap_rps = max_rps_under_wait(dp, latency, budget)
            key = (-cap_rps, latency)
            if best_pre is None or key < best_pre[0]:
                offsets = _layer_offsets(model, inter.num_stages)
                best_pre = (key, PoolPlan(
                    role="prefill",
                    node_counts={t: c for t, c in prefill_counts.items()
                                 if c},
                    node_sequence=inter.node_sequence,
                    device_groups=inter.device_groups,
                    dp=dp,
                    tp_per_stage=tps,
                    layer_partition=tuple(hi - lo for lo, hi in offsets),
                    num_devices=pre_pool.total_devices,
                    max_rps=cap_rps,
                    latency_ms=latency,
                ), compute_ms, send_ms)

        best_dec = None  # (key, PoolPlan, parts)
        dec_counts = {t: sum(1 for n in dec_pool.nodes if n.device_type == t)
                      for t in dec_pool.device_types}
        for inter, dp, tps in _pool_candidates(dec_pool, model, config):
            try:
                batch, tpot_ms, parts, rps, decode_source = _price_decode(
                    dec_pool, profiles, model, config, workload,
                    inter, dp, tps)
            except (ProfileMissError, KvCacheOomError, _PruneBatch):
                num_pruned += 1
                continue
            num_costed += 1
            key = (-rps, tpot_ms)
            if best_dec is None or key < best_dec[0]:
                offsets = _layer_offsets(model, inter.num_stages)
                best_dec = (key, PoolPlan(
                    role="decode",
                    node_counts=dec_counts,
                    node_sequence=inter.node_sequence,
                    device_groups=inter.device_groups,
                    dp=dp,
                    tp_per_stage=tps,
                    layer_partition=tuple(hi - lo for lo, hi in offsets),
                    num_devices=dec_pool.total_devices,
                    max_rps=rps,
                    latency_ms=tpot_ms,
                    batch_per_lane=batch,
                    decode_source=decode_source,
                ), parts)

        if best_pre is None or best_dec is None:
            continue
        _, pre_plan, pre_compute, pre_send = best_pre
        _, dec_plan, (dec_compute, kv_read, dec_comm) = best_dec

        throughput = min(pre_plan.max_rps, dec_plan.max_rps)
        # report queue wait at the offered rate, clamped just under the
        # pool's saturation point so an overloaded plan stays finite (it is
        # already marked infeasible through the throughput check)
        sat_rps = pre_plan.dp * 1000.0 / pre_plan.latency_ms
        lam_eval = min(workload.arrival_rate_rps, 0.95 * sat_rps)
        queueing = queue_wait_p99_ms(lam_eval, pre_plan.dp,
                                     pre_plan.latency_ms)
        components = {
            "queueing": queueing,
            "prefill_compute": pre_compute,
            "prefill_pp_comm": pre_send,
            "kv_handoff": handoff_ms,
            "decode_compute": dec_compute,
            "kv_read": kv_read,
            "decode_pp_comm": dec_comm,
        }
        ttft = queueing + pre_compute + pre_send + handoff_ms
        tpot = dec_compute + kv_read + dec_comm
        slo_ok = (workload.arrival_rate_rps <= throughput
                  and ttft <= workload.slo_ttft_p99_ms
                  and tpot <= workload.slo_tpot_p99_ms)
        cost = InferenceCostBreakdown(
            ttft_p99_ms=ttft,
            tpot_p99_ms=tpot,
            throughput_rps=throughput,
            slo_ok=slo_ok,
            components=components,
            max_concurrency=dec_plan.dp * dec_plan.batch_per_lane,
        )
        split_key = tuple(sorted(prefill_counts.items()))
        ranked.append((
            (not slo_ok, -throughput, ttft, tpot, split_key),
            RankedInferencePlan(prefill=pre_plan, decode=dec_plan, cost=cost),
        ))

    ranked.sort(key=lambda kv: kv[0])
    plans = tuple(p for _, p in ranked[:top_k])
    result = InferencePlannerResult(
        plans=plans, num_costed=num_costed, num_pruned=num_pruned,
        num_splits=num_splits)

    for i, p in enumerate(plans):
        events.emit("inference_plan", rank=i + 1,
                    ttft_p99_ms=p.cost.ttft_p99_ms,
                    tpot_p99_ms=p.cost.tpot_p99_ms,
                    max_rps=p.cost.throughput_rps,
                    prefix_share_frac=workload.prefix_share_frac,
                    kv_page_tokens=workload.page_tokens)
    best = result.best
    if best is not None and not best.cost.slo_ok:
        if best.cost.ttft_p99_ms > workload.slo_ttft_p99_ms:
            events.emit("slo_violation", metric="ttft_p99_ms",
                        value=best.cost.ttft_p99_ms,
                        slo=workload.slo_ttft_p99_ms)
        if best.cost.tpot_p99_ms > workload.slo_tpot_p99_ms:
            events.emit("slo_violation", metric="tpot_p99_ms",
                        value=best.cost.tpot_p99_ms,
                        slo=workload.slo_tpot_p99_ms)
        if workload.arrival_rate_rps > best.cost.throughput_rps:
            events.emit("slo_violation", metric="throughput_rps",
                        value=best.cost.throughput_rps,
                        slo=workload.arrival_rate_rps)
    return result
