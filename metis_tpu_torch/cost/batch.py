"""Batched plan costing — the array-native primary pricing path.

The port's copy of ``metis_tpu/cost/batch.py``.

``BatchCostEstimator`` prices whole batches of (inter, intra) candidates
against precomputed tables instead of re-walking the scalar estimator's
per-stage Python for every candidate:

- **Stage-time matrices** ``E[(type, tp, bs)][start][end]`` — every layer
  slice of every profiled configuration, built once by the exact sequential
  left-to-right accumulation ``LayerProfile.time_slice`` performs, so a
  table lookup returns the scalar path's float VERBATIM (the numpy
  prefix-subtraction ``stage_time_grid`` stays a side API: its association
  differs at the last ulp, which is why it is the rtol-1e-9 oracle and not
  the primary path).
- **Per-placement tables** keyed on ``(node_sequence, device_groups)`` —
  pp-link denominators, dp ring factors, collective-latency floors, and
  per-stage type metadata — shared by every microbatch count and intra
  candidate of a placement.
- **Cross-candidate memos** for boundary-activation volumes, stage
  parameter bytes, optimizer rates, and fb-sync maxima.

Exactness contract: for every candidate the fast path handles (gpipe,
virtual_stages=1, cp=ep=1, zero=0 — the base search family), the returned
``PlanCost`` is bit-identical to ``HeteroCostEstimator.get_cost``: every
float is either produced by the same calls in the same order or by an
IEEE-exact algebraic identity (x/1, x*1.0, x+0.0 for x >= 0, and the
left-associated factoring of the dp ring term).  Candidates outside the
fast family fall through to the scalar estimator wholesale.  The scalar
path is the parity oracle: ``tools/check_search_regression.py`` asserts
ranked-plan byte-identity between the two on the frozen parity workload.

Profile misses replay exactly: tables negative-cache the miss, and
``cost_many`` returns None for a candidate at the same first-missing-stage
point where the scalar path would raise ``ProfileMissError``.
"""
from __future__ import annotations

from typing import Sequence

from metis_tpu_torch.balance.stage_perf import rank_device_types
from metis_tpu_torch.core.errors import MetisError
from metis_tpu_torch.core.types import InterStagePlan, IntraStagePlan, PlanCost
from metis_tpu_torch.cost.bandwidth import HeteroScalarBandwidth

# Negative-cache sentinel: the scalar path raises ProfileMissError here.
_MISS = object()

# Placement-table memo bound (entries): one entry per distinct
# (node_sequence, device_groups); wholesale clear beyond this, so a
# long-lived daemon sweeping many clusters cannot grow it unboundedly.
_PLACEMENT_MEMO_MAX = 8192

# Per-node-sequence memo bound (dp factors, pp denominators, stage metas).
_SEQ_MEMO_MAX = 200_000


class _StageMeta:
    """Per-stage placement facts resolved once per (node_sequence, rank
    range) and SHARED across placements: none of these fields read the
    device grouping beyond the stage's own rank slice, so every placement
    of a node sequence that puts some stage on ranks [r0, r1) reuses the
    same meta — and with it the stage-time and fb-sync tables."""

    __slots__ = ("homo", "types", "typeset", "opt_type", "etabs", "fbtabs")


class _PlacementTables:
    __slots__ = ("bw", "num_stages", "stages", "pp_den", "lat_fn", "latmap",
                 "dpfac", "ranks_uniform", "first_type", "batch_gen",
                 "seq_key", "ranges", "spot_scale")


class BatchCostEstimator:
    """Table-driven batch pricing over a ``HeteroCostEstimator``.

    The scalar estimator supplies the profiles (post affine-view), the
    volume model, the options, and the bandwidth model/memos — this class
    adds the candidate-batch evaluation on top and never diverges from the
    scalar math (see module docstring for the exactness contract).
    """

    def __init__(self, scalar, counters=None, cost_device: str = "cuda"):
        # the reference's jit backend (SearchConfig.cost_backend="jax") is
        # not ported: asking for it raises rather than pricing with numpy
        # under another name
        backend = getattr(scalar.options, "cost_backend", "numpy")
        if backend not in ("numpy", "torch"):
            raise MetisError(
                f"cost_backend={backend!r} is not available in the PyTorch "
                "port; use cost_backend='numpy' or 'torch'")
        self.scalar = scalar
        self.counters = counters
        self.options = scalar.options
        self.profiles = scalar.profiles
        self.volume = scalar.volume
        self._L = scalar.volume.num_layers
        # hoisted invariants of the per-stage assembly
        self._share = scalar.options.dp_exposed_share
        self._overlap = scalar.options.overlap_active
        self._mig_active = scalar.options.migration_active
        self._so = scalar._step_overhead
        self._bg_per = scalar.profiles.model.batch_generator_ms
        # cross-placement memos
        self._pcache: dict = {}   # placement -> _PlacementTables
        self._etabs: dict = {}    # (type, tp, bs) -> slice-sum matrix | _MISS
        self._actmap: dict = {}   # (boundary, mbs, tp) -> activation volume
        self._pmap: dict = {}     # (tp, start, end) -> stage parameter bytes
        self._omap: dict = {}     # (opt_type, tp) -> optimizer ms / tp
        # per-node-sequence memos (see _StageMeta / _build_dpfac): the
        # scalar bandwidth model's dp/pp values are pure functions of the
        # node sequence and explicit rank ranges, so placements share them
        self._seq_meta: dict = {}   # (node_sequence, r0, r1) -> _StageMeta
        self._seq_dpfac: dict = {}  # (node_sequence, r0, r1, dp) -> factor
        self._seq_ppden: dict = {}  # (node_sequence, r0, end2) -> denominator
        # the cost kernel backend (SearchConfig.cost_backend="torch"):
        # shares every memo above through the host reference and stays
        # byte-identical to the numpy loop (cost/torch_backend.py
        # docstring); it runs on ``cost_device`` and its construction raises
        # without a card there or when the kernel does not build.  torch is
        # imported only here, so the numpy path stays torch-free.
        self._torch = None
        if backend == "torch":
            from metis_tpu_torch.cost.torch_backend import TorchCostBackend
            self._torch = TorchCostBackend(self, device=cost_device)

    # -- public API --------------------------------------------------------
    def cost_many(
        self, inter: InterStagePlan, intras: Sequence[IntraStagePlan],
    ) -> list[PlanCost | None]:
        """Price a batch of intra candidates of one inter plan.

        Returns one entry per candidate, aligned with ``intras``:
        a ``PlanCost`` bit-identical to the scalar path's, or None where
        the scalar path would raise ``ProfileMissError``.  An empty batch
        returns an empty list (no tables are touched).
        """
        if not intras:
            return []
        P = self._placement(inter)
        if self._torch is not None:
            return self._torch.cost_many(P, inter, intras)
        return [self._cost_one(P, inter, intra) for intra in intras]

    def _cost_one(self, P, inter, intra):
        strategies = intra.strategies
        if (intra.schedule != "gpipe" or intra.virtual_stages != 1
                or any(s.cp != 1 or s.ep != 1 or s.zero != 0
                       for s in strategies)):
            # outside the fast family (cp/ep/zero/schedule axes): the scalar
            # path prices it — these are a vanishing share of the search
            try:
                return self.scalar.get_cost(
                    inter, strategies, intra.layer_partition,
                    schedule=intra.schedule,
                    virtual_stages=intra.virtual_stages)
            except KeyError:
                return None
        return self._fast(P, inter, strategies, intra.layer_partition)

    # -- fast path ---------------------------------------------------------
    # Term structure (execution + pp/dp exposure + overhead + fb-sync +
    # optimizer + spot/migration) is mirrored by the admissible per-class
    # floors in search/exact.RelaxationBound — a new additive term here
    # needs a matching floor there (or 0, which stays admissible) or the
    # exact backend's certificates go stale.
    def _fast(self, P, inter, strategies, partition):
        batches = inter.batches
        # gbs // dp // batches == (gbs // batches) // dp for positive ints
        g2 = inter.gbs // batches
        stages = P.stages
        S = P.num_stages
        last = S - 1
        pp_den = P.pp_den
        dpfac = P.dpfac
        lat_fn = P.lat_fn
        actmap = self._actmap
        pmap = self._pmap
        omap = self._omap
        share = self._share
        ov = self._overlap
        L = self._L
        sum_l = 0.0
        max_l = max_opt = max_dp = max_dpe = None
        pp_cost = pp_exposed = 0.0
        fb_sync = 0.0
        for s in range(S):
            strat = strategies[s]
            dp = strat.dp
            tp = strat.tp
            start = partition[s]
            end = partition[s + 1]
            meta = stages[s]
            mbs = g2 // dp
            if meta.homo:
                E = meta.etabs.get((tp, mbs))
                if E is None:
                    E = self._build_etab(meta, tp, mbs)
                if E is _MISS:
                    return None
                stage_ms = E[start][end]
            else:
                try:
                    stage_ms = self.scalar._stage_execution_ms(
                        inter, strat, meta.types, start, end)
                except KeyError:
                    return None
            sum_l += stage_ms
            if max_l is None or stage_ms > max_l:
                max_l = stage_ms
            if s == last:
                fb = meta.fbtabs.get((tp, mbs))
                if fb is None:
                    fb = self._build_fb(meta, tp, mbs)
                if fb is _MISS:
                    return None
                fb_sync = fb * batches
            else:
                akey = (end, mbs, tp)
                act = actmap.get(akey)
                if act is None:
                    act = self.scalar._activation(end, mbs, tp)
                    actmap[akey] = act
                if strat.sp:
                    # the scalar divides by cp (==1 here, exact) then tp
                    act = act / tp
                t_pp = act / pp_den[s]
                pp_cost += t_pp
                if ov:
                    # overlap model: the same floats, same max(0, send -
                    # sender compute) as the scalar path (gpipe send
                    # factor is 1.0 so the post-loop scaling is skipped
                    # exactly, like pp_cost itself)
                    pp_exposed += max(0.0, t_pp - stage_ms)
            # the ring factor is tp-independent (dp_bandwidth never reads tp)
            dkey = (s, dp)
            q = dpfac.get(dkey)
            if q is None:
                q = self._build_dpfac(P, s, strat)
                dpfac[dkey] = q
            pkey = (tp, start, end)
            params = pmap.get(pkey)
            if params is None:
                params = self.volume.stage_parameter_bytes(tp, start, end)
                pmap[pkey] = params
            if lat_fn is None:
                dpv = q * params * share
            else:
                lat = P.latmap.get(dp)
                if lat is None:
                    lat = lat_fn("all_reduce", dp)
                    P.latmap[dp] = lat
                dpv = q * params * share + lat
            if max_dp is None or dpv > max_dp:
                max_dp = dpv
            okey = (meta.opt_type, tp)
            o = omap.get(okey)
            if o is None:
                o = self.scalar._optimizer_ms(meta.opt_type) / tp
                omap[okey] = o
            opt = o * (end - start) / L
            if max_opt is None or opt > max_opt:
                max_opt = opt
            if ov:
                # chunked dp sync hides under the optimizer: same dpv/opt
                # floats as the scalar, so the exposed max is bit-identical
                dpe = max(0.0, dpv - opt)
                if max_dpe is None or dpe > max_dpe:
                    max_dpe = dpe

        # gpipe fill-drain (cost/schedule.py) inlined; pp send factor is 1.0
        # and the cp/ep comm delta is exactly 0.0 in this family
        execution = (batches - 1) * max_l + sum_l
        so = self._so
        if so:
            st0 = strategies[0]
            d0, t0 = st0.dp, st0.tp
            uniform = True
            pairs = set()
            for s in range(S):
                strat = strategies[s]
                if strat.dp != d0 or strat.tp != t0:
                    uniform = False
                stp = strat.tp
                for t in stages[s].typeset:
                    pairs.add((t, stp))
            overhead = max((so.get(p, 0.0) for p in pairs), default=0.0)
            if uniform and P.ranks_uniform:
                execution = execution + overhead
            else:
                execution = execution + max(overhead, 0.0) * batches
        if self.options.strict_compat or P.first_type is None:
            batch_gen = self._bg_per * batches
        else:
            batch_gen = P.batch_gen
        dp_charge = max_dpe if ov else max_dp
        pp_charge = pp_exposed if ov else pp_cost
        total = (execution + fb_sync + max_opt + dp_charge + pp_charge
                 + batch_gen)
        # spot model: the scalar's placement-memoized scale verbatim
        # (_placement stores the same float), so recovery and total stay
        # bit-identical to HeteroCostEstimator.get_cost
        recovery = 0.0
        spot_scale = P.spot_scale
        if spot_scale:
            recovery = total * spot_scale
            total = total + recovery
        # migration model: the scalar's memoized helper verbatim — it is a
        # pure function of (tps, partition), so the float here IS the
        # scalar path's
        migration = 0.0
        if self._mig_active:
            migration = self.scalar._migration_ms(
                tuple(s.tp for s in strategies), tuple(partition))
            if migration:
                total = total + migration
        return PlanCost(
            total_ms=total,
            execution_ms=execution,
            fb_sync_ms=fb_sync,
            optimizer_ms=max_opt,
            dp_comm_ms=dp_charge,
            pp_comm_ms=pp_charge,
            batch_gen_ms=batch_gen,
            cp_comm_ms=0.0,
            ep_comm_ms=0.0,
            expected_recovery_ms=recovery,
            migration_ms=migration,
        )

    # -- table builders ----------------------------------------------------
    def _placement(self, plan: InterStagePlan) -> _PlacementTables:
        key = (plan.node_sequence, plan.device_groups)
        P = self._pcache.get(key)
        if P is not None:
            return P
        scalar = self.scalar
        opts = self.options
        bw = scalar._bandwidth_for(plan)
        ranks = rank_device_types(scalar.cluster, plan.node_sequence)
        S = plan.num_stages
        P = _PlacementTables()
        P.bw = bw
        P.num_stages = S
        P.ranks_uniform = len(set(ranks)) <= 1
        P.first_type = ranks[0] if ranks else None
        P.lat_fn = getattr(bw, "collective_latency_ms", None)
        P.latmap = {}
        P.dpfac = {}
        # The scalar bandwidth model's dp/pp values depend only on the node
        # sequence and explicit rank ranges (bandwidth.py: _rank_node and
        # node_types are built from node_sequence alone), so they memo
        # globally per sequence.  Other factories (e.g. plan_tpu's ici/dcn
        # closure) stay per-placement and go through the model's methods.
        P.seq_key = (plan.node_sequence
                     if isinstance(bw, HeteroScalarBandwidth) else None)
        strict = opts.strict_compat
        seq_meta = self._seq_meta
        seq_ppden = self._seq_ppden
        groups = plan.device_groups
        stages = []
        pp_den = []
        ranges = []
        for s in range(S):
            r0, r1 = plan.stage_rank_range(s)
            ranges.append((r0, r1))
            mkey = (plan.node_sequence, r0, r1)
            meta = seq_meta.get(mkey)
            if meta is None:
                types = ranks[r0:r1]
                meta = _StageMeta()
                meta.types = types
                meta.typeset = tuple(set(types))
                meta.homo = len(meta.typeset) == 1
                meta.opt_type = None if strict else types[0]
                meta.etabs = {}
                meta.fbtabs = {}
                if len(seq_meta) > _SEQ_MEMO_MAX:
                    seq_meta.clear()
                seq_meta[mkey] = meta
            stages.append(meta)
            # pp denominator of the s -> s+1 boundary (unused for the last)
            if s >= S - 1:
                pp_den.append(0.0)
            elif P.seq_key is not None:
                end2 = r1 + groups[s + 1]
                gkey = (P.seq_key, r0, end2)
                den = seq_ppden.get(gkey)
                if den is None:
                    # == bw.pp_bandwidth(s): _group_bandwidth over the two
                    # adjacent stages' combined rank range, verbatim
                    den = opts.bw_to_bytes_per_ms(
                        bw._group_bandwidth(range(r0, end2)))
                    if len(seq_ppden) > _SEQ_MEMO_MAX:
                        seq_ppden.clear()
                    seq_ppden[gkey] = den
                pp_den.append(den)
            else:
                pp_den.append(opts.bw_to_bytes_per_ms(bw.pp_bandwidth(s)))
        P.stages = stages
        P.pp_den = pp_den
        P.ranges = ranges
        P.batch_gen = (
            scalar.profiles.type_meta[P.first_type].batch_generator_ms
            if (not strict and P.first_type is not None) else 0.0)
        P.spot_scale = scalar._spot_scale(plan)
        if len(self._pcache) >= _PLACEMENT_MEMO_MAX:
            self._pcache.clear()
            if self.counters is not None:
                self.counters.inc("memo.placement.evict")
        if self.counters is not None:
            self.counters.inc("memo.placement.built")
        self._pcache[key] = P
        return P

    def _build_etab(self, meta, tp, bs):
        """Slice-sum matrix of one (type, tp, bs) profile: entry [i][j] is
        the SEQUENTIAL sum of layer times [i, j) — bit-identical to
        ``LayerProfile.time_slice`` (and to the /cp==1 scalar stage time)."""
        key = (meta.types[0], tp, bs)
        tab = self._etabs.get(key)
        if tab is None:
            try:
                times = self.profiles.get(*key).layer_times_ms
            except KeyError:
                tab = _MISS
            else:
                n = len(times)
                tab = []
                for start in range(n + 1):
                    row = [0.0] * (n + 1)
                    acc = 0
                    for end in range(start, n):
                        acc = acc + times[end]
                        row[end + 1] = acc
                    tab.append(row)
            self._etabs[key] = tab
        meta.etabs[(tp, bs)] = tab
        return tab

    def _build_fb(self, meta, tp, bs):
        try:
            fb = max(self.profiles.get(t, tp, bs).fb_sync_ms
                     for t in meta.typeset)
        except KeyError:
            fb = _MISS
        meta.fbtabs[(tp, bs)] = fb
        return fb

    def _build_dpfac(self, P, s, strat):
        """The dp ring term's candidate-independent factor: the scalar's
        ``2*(dp-1) / (dp*B)`` sub-expression (its own left-associated
        grouping), so ``factor * param_bytes`` reproduces ``_dp_cost_ms``
        bitwise.  For the scalar bandwidth model the ring bandwidth depends
        only on (node_sequence, rank range, dp), so the factor memos
        globally per sequence — the big win at scale, where each placement
        sees only a handful of candidates but thousands of placements share
        the same few stage rank ranges."""
        dp = strat.dp
        if dp <= 1:
            return 0.0
        if P.seq_key is not None:
            r0, r1 = P.ranges[s]
            gkey = (P.seq_key, r0, r1, dp)
            q = self._seq_dpfac.get(gkey)
            if q is None:
                # == P.bw.dp_bandwidth(s, strat): slowest strided dp ring
                # over the stage's ranks, min-chained in the same order
                bw_model = P.bw
                ranks = list(range(r0, r1))
                slowest = float("inf")
                for d in range(dp):
                    slowest = min(
                        slowest, bw_model._group_bandwidth(ranks[d::dp]))
                q = 2 * (dp - 1) / (
                    dp * self.options.bw_to_bytes_per_ms(slowest))
                if len(self._seq_dpfac) > _SEQ_MEMO_MAX:
                    self._seq_dpfac.clear()
                self._seq_dpfac[gkey] = q
            return q
        bw = P.bw.dp_bandwidth(s, strat)
        return 2 * (dp - 1) / (dp * self.options.bw_to_bytes_per_ms(bw))
