"""Plan types — the port's copy of ``UniformPlan`` and ``divisors`` from
``metis_tpu/core/types.py``."""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Iterator


@dataclass(frozen=True)
class UniformPlan:
    """One homogeneous Megatron-style plan: dp×pp×tp grid + batch split."""

    dp: int
    pp: int
    tp: int
    mbs: int
    gbs: int

    @property
    def num_microbatches(self) -> int:
        return self.gbs // self.mbs // self.dp

    def valid_for(self, num_devices: int) -> bool:
        return (
            self.dp * self.pp * self.tp == num_devices
            and self.gbs % (self.mbs * self.dp) == 0
        )


@lru_cache(maxsize=8192)
def _divisors_ascending(n: int) -> tuple[int, ...]:
    small: list[int] = []
    large: list[int] = []
    i = 1
    while i * i <= n:
        if n % i == 0:
            small.append(i)
            if i * i != n:
                large.append(n // i)
        i += 1
    return tuple(small + large[::-1])


def divisors(n: int, descending: bool = False) -> Iterator[int]:
    """All divisors of n (ascending by default)."""
    ds = _divisors_ascending(n)
    return iter(reversed(ds)) if descending else iter(ds)
