"""Device-group enumeration: how many chips each pipeline stage gets.

The port's copy of ``metis_tpu/search/device_groups.py``.

Re-derivation of the reference's three "key ideas" (``search_space/
device_group.py``):

1. group sizes restricted to powers of two (``gen_device_group_shapes:84-90``)
   — on TPU this is also the hardware-true constraint: a power-of-two group
   maps onto a contiguous ICI sub-torus;
2. a variance knob that discards groups much smaller than the even share
   (``gen_dgroups_for_stages_with_variance:93-98``);
3. a permutation-length cap that merges equal-size smallest groups pairwise
   before permuting stage order, bounding the orderings explosion
   (``permute:7-55``).

The composition enumerator and the merge cap reproduce the reference's
*observable* outputs (oracle-tested against the upstream module in
tests/test_search_parity.py); the implementation is our own.
"""
from __future__ import annotations

from itertools import chain
from typing import Iterator, Sequence

from metis_tpu_torch.search.multiperm import multiset_permutations


def type_equivalence_classes(cluster, profiles) -> dict[str, str]:
    """Map each device type to its class representative under cost symmetry.

    Two types are interchangeable for the planner (AMP-style placement
    symmetry, arXiv 2210.07297) iff NOTHING the cost model reads can tell
    them apart: identical ``DeviceSpec`` cost fields (everything but the
    name), identical per-type node-width sequences (node order is rank
    order, so widths must match position-for-position), identical profiled
    configs with bit-equal ``LayerProfile`` data, and identical
    ``type_meta`` timings.  Swapping two such types inside a
    ``node_sequence`` then reprices to bit-identical floats, which is what
    lets the evaluator cost one representative per class and replay the
    result stream for the equivalent permutations (search/parallel.py).

    The representative is the lexicographically smallest name in the
    class, so the canonical form of a sequence is deterministic.  Clusters
    with no equivalent pair map every type to itself.
    """
    sigs: dict[tuple, list[str]] = {}
    for t in cluster.device_types:
        spec = cluster.devices[t]
        widths = tuple(n.num_devices for n in cluster.nodes
                       if n.device_type == t)
        meta = profiles.type_meta.get(t)
        profile_sig = []
        for (_, tp, bs) in sorted(profiles.configs(t)):
            prof = profiles.get(t, tp, bs)
            profile_sig.append((tp, bs, tuple(prof.layer_times_ms),
                                tuple(prof.layer_memory_mb),
                                prof.fb_sync_ms))
        sig = (
            spec.memory_gb, spec.intra_bw_gbps, spec.inter_bw_gbps,
            spec.hbm_gbps, spec.tier, spec.preemption_rate_per_hr,
            widths,
            None if meta is None else (meta.optimizer_time_ms,
                                       meta.batch_generator_ms),
            tuple(profile_sig),
        )
        sigs.setdefault(sig, []).append(t)
    out: dict[str, str] = {}
    for members in sigs.values():
        rep = min(members)
        for t in members:
            out[t] = rep
    return out


def power_of_two_shapes(num_devices: int) -> list[int]:
    """Allowed per-stage group sizes: 1, 2, 4, ... <= num_devices."""
    shapes = []
    p = 1
    while p <= num_devices:
        shapes.append(p)
        p *= 2
    return shapes


def nondecreasing_compositions(
    num_stages: int, total: int, shapes: Sequence[int]
) -> Iterator[tuple[int, ...]]:
    """All non-decreasing ways to write ``total`` as a sum of ``num_stages``
    values drawn (with repetition) from ``shapes``."""
    shapes = sorted(shapes)
    if not shapes:
        return

    def rec(remaining: int, stages_left: int, min_idx: int) -> Iterator[tuple[int, ...]]:
        if stages_left == 0:
            if remaining == 0:
                yield ()
            return
        for i in range(min_idx, len(shapes)):
            s = shapes[i]
            if s > remaining or s * stages_left > remaining:
                break  # shapes ascending + non-decreasing suffix ⇒ no fit
            if shapes[-1] * (stages_left - 1) < remaining - s:
                continue  # even the largest shape can't absorb the rest
            for rest in rec(remaining - s, stages_left - 1, i):
                yield (s, *rest)

    yield from rec(total, num_stages, 0)


def merge_for_permute_cap(
    composition: Sequence[int], max_permute_len: int
) -> list[tuple[int, ...]]:
    """Bound permutation count by fusing equal-size smallest groups pairwise.

    Takes a non-decreasing composition; returns "super-groups" (tuples of
    original group sizes) whose count is at most ``max_permute_len`` when
    achievable.  Behavioral parity with the reference's ``permute`` merge
    phase, including its two quirks we keep deliberately (oracle-tested):
    it may over-merge (half the smallest groups fuse even when fewer merges
    would do), and after a partial merge the leading group may no longer be
    the smallest.
    """
    groups: list[tuple[int, ...]] = [(g,) for g in composition]
    reduce_target = len(groups) - max_permute_len
    while reduce_target > 0:
        lead = groups[0]
        lead_sum = sum(lead)
        lead_count = 0
        for g in groups:
            if g != lead:
                break
            lead_count += 1
        # Reference's find_num_min (device_group.py:8-12) returns the index of
        # the first non-equal group plus one — i.e. leading-run + 1 unless the
        # whole list is equal.  The over-merge decision keys on that value, so
        # we reproduce it exactly (oracle-tested).
        min_run = lead_count if lead_count == len(groups) else lead_count + 1
        reduce_target = max(reduce_target, min_run // 2)

        merged: list[tuple[int, ...]] = []
        for i in range(0, len(groups), 2):
            if reduce_target <= i // 2:
                merged.extend(groups[i:])
                break
            if i + 1 >= len(groups):
                merged.append(groups[i])
            elif sum(groups[i]) == lead_sum and sum(groups[i + 1]) == lead_sum:
                merged.append(groups[i] + groups[i + 1])
            else:
                merged.append(groups[i])
                merged.append(groups[i + 1])

        groups = merged
        if reduce_target == len(groups) - max_permute_len:
            break  # no further reduction possible
        reduce_target = len(groups) - max_permute_len
    return groups


def arrangements_of_composition(
    composition: Sequence[int], max_permute_len: int
) -> Iterator[tuple[int, ...]]:
    """All stage orderings of one composition, under the permutation cap.

    Super-groups permute as units and are then flattened back to per-stage
    sizes (≅ reference ``permute`` + ``chain`` at ``device_group.py:102-105``).
    """
    groups = merge_for_permute_cap(composition, max_permute_len)
    for perm in multiset_permutations(groups):
        yield tuple(chain.from_iterable(perm))


# Arrangement-space memo: explicit bounded dict (was an lru_cache) so the
# hit/miss/evict traffic is observable through the flight recorder's
# counters like every other costing memo layer.  Wholesale clear past the
# bound — the space count per key is small, the values are what's big.
_MEMO_MAX = 4096
_memo: dict[tuple, tuple[tuple[int, ...], ...]] = {}


def enumerate_device_groups(
    num_stages: int,
    num_devices: int,
    variance: float = 1.0,
    max_permute_len: int = 6,
    shapes: Sequence[int] | None = None,
    counters=None,
) -> Sequence[tuple[int, ...]]:
    """Every candidate per-stage device-count arrangement for a stage count.

    ``variance`` filters shapes below ``max(num_devices // num_stages,
    num_stages // num_devices) * variance`` — the reference's "key idea 1"
    (small-group pruning).

    Memoized across calls: the arrangement space depends only on the
    arguments, and both replanning (``planner/replan.replan_on_drift``) and
    the sharded parallel workers re-enumerate the identical space.  Callers
    receive a shared immutable tuple — iterate, don't mutate.

    ``counters``: optional ``core.trace.Counters`` — bumps
    ``memo.device_groups.{hit,miss,evict}``.
    """
    key = (num_stages, num_devices, variance, max_permute_len,
           None if shapes is None else tuple(shapes))
    cached = _memo.get(key)
    if cached is not None:
        if counters is not None:
            counters.inc("memo.device_groups.hit")
        return cached
    if counters is not None:
        counters.inc("memo.device_groups.miss")
    out = _enumerate_device_groups(*key)
    if len(_memo) > _MEMO_MAX:
        _memo.clear()
        if counters is not None:
            counters.inc("memo.device_groups.evict")
    _memo[key] = out
    return out


def _enumerate_device_groups(
    num_stages: int,
    num_devices: int,
    variance: float,
    max_permute_len: int,
    shapes: tuple[int, ...] | None,
) -> tuple[tuple[int, ...], ...]:
    all_shapes = list(shapes) if shapes is not None else power_of_two_shapes(num_devices)
    min_group = max(num_devices // num_stages, num_stages // num_devices) * variance
    eligible = [s for s in all_shapes if s >= min_group]

    out: list[tuple[int, ...]] = []
    for comp in nondecreasing_compositions(num_stages, num_devices, eligible):
        out.extend(arrangements_of_composition(comp, max_permute_len))
    return tuple(out)
