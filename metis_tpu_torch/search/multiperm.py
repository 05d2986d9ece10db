"""Distinct permutations of a multiset.

The port's copy of ``metis_tpu/search/multiperm.py``.

The reference vendors Williams' loopless algorithm from ekg/multipermute
(``search_space/utils.py``, see its NOTICE).  We use a counting backtracker
instead: simpler, allocation-light, and yields in lexicographic order (the
reference's emission order differs, but every consumer treats the result as a
set).
"""
from __future__ import annotations

from collections import Counter
from typing import Hashable, Iterable, Iterator, Sequence, TypeVar

T = TypeVar("T", bound=Hashable)


def multiset_permutations(items: Sequence[T]) -> Iterator[tuple[T, ...]]:
    """Yield each distinct ordering of ``items`` exactly once."""
    counts = Counter(items)
    keys = sorted(counts)
    n = len(items)
    path: list[T] = []

    def rec() -> Iterator[tuple[T, ...]]:
        if len(path) == n:
            yield tuple(path)
            return
        for k in keys:
            if counts[k]:
                counts[k] -= 1
                path.append(k)
                yield from rec()
                path.pop()
                counts[k] += 1

    return rec()


def count_multiset_permutations(items: Iterable[T]) -> int:
    """n! / prod(m_i!) without enumerating."""
    import math

    counts = Counter(items)
    n = sum(counts.values())
    total = math.factorial(n)
    for m in counts.values():
        total //= math.factorial(m)
    return total
