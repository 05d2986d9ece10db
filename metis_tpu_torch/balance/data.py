"""Data load balancing: split a stage's batch across heterogeneous DP replicas.

The port's copy of ``metis_tpu/balance/data.py``.

≅ reference ``DataLoadBalancer`` (``model/load_balancer.py:147-179``):
each replica gets batch ∝ 1/exec-time (profiled at tp{N}_bs1), rounded by
largest remainder.  Tie-breaking matches the reference exactly (stable sort on
descending fractional remainder ⇒ earlier replicas win ties) — differential
tests depend on it.
"""
from __future__ import annotations

from typing import Sequence

from metis_tpu_torch.profiles.store import ProfileStore


def replica_chunks(device_types: Sequence[str], dp: int) -> list[list[str]]:
    """Contiguous device chunks per DP replica (reference convention:
    ``load_balancer.py:159-161`` slices the stage's rank list into dp equal
    runs; the chunk's first device represents the replica)."""
    group = len(device_types) // dp
    return [list(device_types[i * group: (i + 1) * group]) for i in range(dp)]


def proportional_split(weights: Sequence[float], total: int) -> list[int]:
    """Integer split of ``total`` ∝ ``weights`` with largest-remainder
    rounding (reference ``partition_data`` tail, ``load_balancer.py:169-177``)."""
    wsum = sum(weights)
    shares = [total * w / wsum for w in weights]
    out = [int(s) for s in shares]
    remainder = total - sum(out)
    order = sorted(range(len(weights)), key=lambda i: shares[i] - out[i], reverse=True)
    for i in range(remainder):
        out[order[i]] += 1
    return out


def power_of_two_chunks(n: int) -> list[int]:
    """Decompose n into descending powers of two (binary digits) — hetero
    microbatches are costed as sums of profiled power-of-two batches
    (reference ``comb_h_mbs``, ``cost_estimator.py:162``)."""
    out = []
    bit = 1 << (n.bit_length() - 1) if n else 0
    while bit:
        if n & bit:
            out.append(bit)
        bit >>= 1
    return out


class DataBalancer:
    """Splits per-step stage batches across replicas by profiled speed."""

    def __init__(self, profiles: ProfileStore):
        self.profiles = profiles

    def replica_exec_time(self, device_type: str, tp: int, bs: int) -> float:
        """Execution time of one replica microbatch, composed from profiled
        power-of-two batch sizes."""
        return sum(
            self.profiles.get(device_type, tp, chunk).total_time_ms
            for chunk in power_of_two_chunks(bs)
        )

    def partition(
        self, device_types: Sequence[str], dp: int, tp: int, batch: int
    ) -> list[int]:
        """Per-replica batch sizes for one stage step (≅ ``partition_data``)."""
        chunks = replica_chunks(device_types, dp)
        speeds = [
            1.0 / self.profiles.get(chunk[0], tp, 1).total_time_ms
            for chunk in chunks
        ]
        return proportional_split(speeds, batch)
