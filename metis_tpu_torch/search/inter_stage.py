"""Inter-stage (pipeline-level) plan enumeration for heterogeneous clusters.

The port's copy of ``metis_tpu/search/inter_stage.py``.

The reference's outer hot loop (``search_space/plan.py:100-175``): device-type
placement permutations × stage counts × device-group arrangements ×
microbatch counts.  Rewritten as a plain generator — the reference's odometer
object with mutating ``__next__`` state is an implementation detail, not a
behavior; the enumerated *set* is oracle-tested for parity.
"""
from __future__ import annotations

from itertools import permutations
from typing import Iterator, Sequence

from metis_tpu_torch.core.types import InterStagePlan, divisors
from metis_tpu_torch.search.device_groups import enumerate_device_groups


def sequence_symmetry_stats(
    device_types: Sequence[str], class_map: dict[str, str],
) -> tuple[int, int]:
    """(total, distinct) type-permutation counts under an equivalence map.

    ``total`` is the number of node-sequence permutations the search walks;
    ``distinct`` how many remain after canonicalizing each through
    ``class_map`` (device_groups.type_equivalence_classes) — the
    denominator/numerator of the ``symmetry_collapse`` event's
    ``collapse_frac``."""
    types = sorted(set(device_types))
    total = 0
    distinct: set[tuple] = set()
    for perm in permutations(types):
        total += 1
        distinct.add(tuple(class_map.get(t, t) for t in perm))
    return total, len(distinct)


def stage_compositions(
    num_devices: int,
    num_layers: int,
    variance: float = 1.0,
    max_stages: int | None = None,
) -> Iterator[tuple[int, tuple[int, ...]]]:
    """Yield every (stage count, non-decreasing composition) class of the
    search space — the branch nodes shared by the composition-level pruned
    walk (``search/prune.pruned_inter_stage_plans``) and the exact
    branch-and-bound backend (``search/exact.py``).  One definition, so the
    spaces the two backends cover cannot drift: a composition appears here
    iff some arrangement of it appears in the flat walk."""
    from metis_tpu_torch.search.device_groups import (
        nondecreasing_compositions,
        power_of_two_shapes,
    )

    cap = min(num_devices, num_layers)
    if max_stages is not None:
        cap = min(cap, max_stages)
    all_shapes = power_of_two_shapes(num_devices)
    for num_stage in range(1, cap + 1):
        min_group = max(num_devices // num_stage,
                        num_stage // num_devices) * variance
        eligible = [s for s in all_shapes if s >= min_group]
        for comp in nondecreasing_compositions(
                num_stage, num_devices, eligible):
            yield num_stage, comp


def inter_stage_plans(
    device_types: Sequence[str],
    num_devices: int,
    gbs: int,
    num_layers: int,
    variance: float = 1.0,
    max_permute_len: int = 6,
    max_stages: int | None = None,
    counters=None,
) -> Iterator[InterStagePlan]:
    """Yield every inter-stage candidate.

    Stage count is capped at ``min(num_devices, num_layers)`` (a stage needs
    at least one layer and one device, ``plan.py:139,165``); microbatch counts
    sweep the divisors of gbs descending (``plan.py:120-124``).

    ``counters``: optional ``core.trace.Counters`` — every yielded candidate
    bumps ``inter_enumerated`` for the flight recorder's search accounting.
    """
    cap = min(num_devices, num_layers)
    if max_stages is not None:
        cap = min(cap, max_stages)
    batch_options = list(divisors(gbs, descending=True))
    # Group arrangements don't depend on the node sequence — compute once per
    # stage count, not once per device-type permutation.
    groups_by_stage = {
        n: enumerate_device_groups(n, num_devices, variance, max_permute_len,
                                   counters=counters)
        for n in range(1, cap + 1)
    }

    for node_sequence in permutations(sorted(set(device_types))):
        for num_stage in range(1, cap + 1):
            for groups in groups_by_stage[num_stage]:
                for batches in batch_options:
                    if counters is not None:
                        counters.inc("inter_enumerated")
                    yield InterStagePlan(
                        node_sequence=tuple(node_sequence),
                        device_groups=groups,
                        batches=batches,
                        gbs=gbs,
                    )
