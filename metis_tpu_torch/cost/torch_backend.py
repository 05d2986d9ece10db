"""The batched cost tensor on the card — the torch backend for batched
costing, the counterpart of ``metis_tpu/cost/jax_backend.py``.

``TorchCostBackend`` prices the fast family (gpipe, virtual_stages=1,
cp=ep=1, zero=0) of a candidate batch through one launch of the hand-written
CUDA cost kernel (``ops/cost_tensor.py``, ``ops/csrc/cost_tensor.cu``)
instead of ``BatchCostEstimator._fast``'s per-candidate Python loop.  The
host side is the reference's verbatim: it gathers exactly the same memoized
tables ``_fast`` reads (stage-time slice-sum matrices, activation volumes,
dp ring factors, parameter bytes, optimizer rates, latency floors) into one
f64 ``[7 S + 4, B]`` array; the kernel then replays the per-stage assembly
with the same operations in the same association order, one thread per
candidate and a loop over the S stages.

Exactness contract (the reference's): every float the kernel produces is
either the result of the identical IEEE-754 double operation sequence
``_fast`` performs, or of an exact identity (``x + 0.0`` for ``x >= 0``).
Candidate selection, profile misses, and the non-fast-family scalar
fallback are decided on the host with byte-for-byte the code ``_cost_one``
runs, so a batch returns the same ``PlanCost | None`` list in the same order
and the ranked dump is byte-identical to the numpy backend's.

Device: the kernel runs on the card (``device="cuda"``, the default) and
the backend raises at construction without one, or when the kernel does
not build; there is no quiet fallback to numpy or to the plain version.  On
``device="cpu"``, asked for explicitly, the wrapper runs its plain PyTorch
version (the tests do).  The stage count is a runtime argument, so nothing
is retraced; ``memo.torch_kernel.{hit,miss}`` count the reference's
specialization keys all the same, so the two packages' counters agree.
"""
from __future__ import annotations

import numpy as np
import torch

from metis_tpu_torch.core.device import resolve_device
from metis_tpu_torch.core.types import PlanCost
from metis_tpu_torch.cost.batch import _MISS
from metis_tpu_torch.ops import cost_tensor as ct


class TorchCostBackend:
    """Batch-cost evaluation via the cost kernel, over a host
    ``BatchCostEstimator`` that owns every table and memo."""

    def __init__(self, host, device: str = "cuda"):
        self.host = host
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            ct.kernel_library()  # build now: a failed build fails the search
        self._specs_seen: set = set()

    # -- public API --------------------------------------------------------
    def cost_many(self, P, inter, intras):
        """Price one inter plan's intra batch; same contract as the host's
        ``cost_many`` (entry per candidate, None on profile miss)."""
        host = self.host
        results: list = [None] * len(intras)
        rows = []
        rows_idx = []
        for i, intra in enumerate(intras):
            strategies = intra.strategies
            if (intra.schedule != "gpipe" or intra.virtual_stages != 1
                    or any(s.cp != 1 or s.ep != 1 or s.zero != 0
                           for s in strategies)):
                # non-fast family: scalar path, verbatim from _cost_one
                try:
                    results[i] = host.scalar.get_cost(
                        inter, strategies, intra.layer_partition,
                        schedule=intra.schedule,
                        virtual_stages=intra.virtual_stages)
                except KeyError:
                    results[i] = None
                continue
            g = self._gather(P, inter, strategies, intra.layer_partition)
            if g is None:
                results[i] = None
                continue
            rows.append(g)
            rows_idx.append(i)
        if not rows:
            return results
        self._price(P, inter, rows, rows_idx, results)
        return results

    # -- host-side gather --------------------------------------------------
    def _gather(self, P, inter, strategies, partition):
        """One candidate's kernel inputs — the same memoized lookups, in
        the same order, as ``_fast``; None at the same miss points."""
        host = self.host
        batches = inter.batches
        g2 = inter.gbs // batches
        stages = P.stages
        S = P.num_stages
        last = S - 1
        dpfac = P.dpfac
        lat_fn = P.lat_fn
        actmap = host._actmap
        pmap = host._pmap
        omap = host._omap
        stage_row = [0.0] * S
        act_row = [0.0] * last
        q_row = [0.0] * S
        params_row = [0.0] * S
        lat_row = [0.0] * S
        o_row = [0.0] * S
        span_row = [0.0] * S
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
                    E = host._build_etab(meta, tp, mbs)
                if E is _MISS:
                    return None
                stage_row[s] = E[start][end]
            else:
                try:
                    stage_row[s] = host.scalar._stage_execution_ms(
                        inter, strat, meta.types, start, end)
                except KeyError:
                    return None
            if s == last:
                fb = meta.fbtabs.get((tp, mbs))
                if fb is None:
                    fb = host._build_fb(meta, tp, mbs)
                if fb is _MISS:
                    return None
                fb_sync = fb * batches
            else:
                akey = (end, mbs, tp)
                act = actmap.get(akey)
                if act is None:
                    act = host.scalar._activation(end, mbs, tp)
                    actmap[akey] = act
                if strat.sp:
                    act = act / tp
                act_row[s] = act
            dkey = (s, dp)
            q = dpfac.get(dkey)
            if q is None:
                q = host._build_dpfac(P, s, strat)
                dpfac[dkey] = q
            q_row[s] = q
            pkey = (tp, start, end)
            params = pmap.get(pkey)
            if params is None:
                params = host.volume.stage_parameter_bytes(tp, start, end)
                pmap[pkey] = params
            params_row[s] = params
            if lat_fn is not None:
                lat = P.latmap.get(dp)
                if lat is None:
                    lat = lat_fn("all_reduce", dp)
                    P.latmap[dp] = lat
                lat_row[s] = lat
            okey = (meta.opt_type, tp)
            o = omap.get(okey)
            if o is None:
                o = host.scalar._optimizer_ms(meta.opt_type) / tp
                omap[okey] = o
            o_row[s] = o
            span_row[s] = float(end - start)
        extra_once = extra_pb = 0.0
        so = host._so
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
                extra_once = overhead
            else:
                extra_pb = max(overhead, 0.0)
        if host.options.strict_compat or P.first_type is None:
            batch_gen = host._bg_per * batches
        else:
            batch_gen = P.batch_gen
        migration = 0.0
        if host._mig_active:
            migration = host.scalar._migration_ms(
                tuple(s.tp for s in strategies), tuple(partition))
        return (stage_row, act_row, q_row, params_row, lat_row, o_row,
                span_row, fb_sync, batch_gen, migration, extra_once,
                extra_pb)

    # -- kernel dispatch ---------------------------------------------------
    def _price(self, P, inter, rows, rows_idx, results):
        host = self.host
        S = P.num_stages
        ov = host._overlap
        has_lat = P.lat_fn is not None
        spot_scale = P.spot_scale
        has_spot = bool(spot_scale)
        has_mig = host._mig_active
        share = host._share
        L = host._L
        B = len(rows)
        # the reference's retrace key (its batch axis padded to a power of
        # two); the kernel takes every shape at run time, the counters
        # still count the same hits and misses
        bpad = 1
        while bpad < B:
            bpad *= 2
        spec = (S, ov, has_lat, has_spot, has_mig, share, L, bpad)
        c = host.counters
        if c is not None:
            if spec in self._specs_seen:
                c.inc("memo.torch_kernel.hit")
            else:
                self._specs_seen.add(spec)
                c.inc("memo.torch_kernel.miss")
        # one host buffer, one copy to the device: x, then pp_den
        x = ct.pack_rows(rows, S)
        buf = np.concatenate((x.reshape(-1), np.asarray(
            P.pp_den[:S - 1], dtype=np.float64)))
        dev = torch.from_numpy(buf).to(self.device)
        out = ct.cost_tensor(
            dev[:x.size].view(x.shape), dev[x.size:], float(inter.batches),
            float(spot_scale), float(L), float(share), S=S, ov=ov,
            has_lat=has_lat, has_spot=has_spot, has_mig=has_mig)
        total, execution, max_opt, dp_charge, pp_charge, recovery = (
            out.cpu().numpy())
        for r, i in enumerate(rows_idx):
            g = rows[r]
            results[i] = PlanCost(
                total_ms=float(total[r]),
                execution_ms=float(execution[r]),
                fb_sync_ms=g[7],
                optimizer_ms=float(max_opt[r]),
                dp_comm_ms=float(dp_charge[r]),
                pp_comm_ms=float(pp_charge[r]),
                batch_gen_ms=g[8],
                cp_comm_ms=0.0,
                ep_comm_ms=0.0,
                expected_recovery_ms=float(recovery[r]),
                migration_ms=g[9],
            )
