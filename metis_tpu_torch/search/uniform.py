"""Uniform (homogeneous, Megatron-grid) plan enumeration.

The port's copy of ``metis_tpu/search/uniform.py``.

Covers the reference ``UniformPlanGenerator`` space (``search_space/
plan.py:40-97``): every (dp, pp, tp) with dp·pp·tp == num_devices and
tp <= max_tp, crossed with global/micro batch sizes.

Deliberate deviation (documented; see tests/test_search_parity.py): the
reference admits ragged batch splits — it only requires ``mbs·dp <= gbs``, so
``gbs // mbs // dp`` can truncate (``plan.py:84``, ``cost_estimator.py:106``).
We require exact divisibility ``dp·mbs | gbs``: a truncated microbatch count
costs a plan that silently drops samples, which the execution layer could
never run faithfully.
"""
from __future__ import annotations

from typing import Iterator

from metis_tpu_torch.core.types import UniformPlan, divisors


def grid_degrees(num_devices: int, max_tp: int, max_pp: int | None = None) -> Iterator[tuple[int, int, int]]:
    """All (dp, pp, tp) with dp·pp·tp == num_devices, tp <= max_tp."""
    for pp in divisors(num_devices):
        if max_pp is not None and pp > max_pp:
            continue
        per_stage = num_devices // pp
        for tp in divisors(per_stage):
            if tp > max_tp:
                continue
            yield per_stage // tp, pp, tp


def uniform_plans(
    num_devices: int,
    max_tp: int,
    gbs: int,
    max_pp: int | None = None,
    sweep_gbs: bool = False,
    max_gbs: int | None = None,
) -> Iterator[UniformPlan]:
    """Enumerate uniform plans at a fixed global batch size (the reference
    generator sweeps gbs but its caller filters to the requested one,
    ``cost_homo_cluster.py:25`` — we expose the sweep behind ``sweep_gbs``)."""
    gbs_values = (
        [g for g in divisors(max_gbs or gbs) ] if sweep_gbs else [gbs]
    )
    for dp, pp, tp in grid_degrees(num_devices, max_tp, max_pp):
        for g in gbs_values:
            if g % dp:
                continue
            per_replica = g // dp
            for mbs in divisors(per_replica):
                yield UniformPlan(dp=dp, pp=pp, tp=tp, mbs=mbs, gbs=g)
