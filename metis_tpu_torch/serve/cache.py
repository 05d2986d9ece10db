"""Sharded LRU plan cache for the serve daemon — the port of
``metis_tpu/serve/cache.py``.

Keys are serve-layer query fingerprints (``obs.ledger.query_fingerprint``
— model × cluster × every cost-relevant SearchConfig field — suffixed
with the requested top_k); values are fully rendered response payloads so
a hit is a dict copy, not a re-serialization.  Accounting lands in the
``serve.cache.*`` counters the daemon's ``/stats`` endpoint exposes:
``hit``/``miss`` per lookup, ``evict`` when capacity pushes out the
least-recently-used entry, ``invalidate`` per entry dropped by a drift
alarm or cluster delta.

Two serve-hot-path features beyond a plain locked OrderedDict:

* **Sharding** — keys hash (stable ``zlib.crc32``) onto ``shards``
  independent segments, each with its own lock, so concurrent request
  threads on distinct fingerprints never contend.  The capacity bound
  stays *global*: every access stamps its entry from one monotonic
  counter, and eviction removes the globally least-recent head across
  all shards.  ``items()``/``keys()`` return stamp-ordered snapshots, so
  export/restore is shard-order-independent and a ``shards=1`` cache is
  byte-identical (dump-wise) to the pre-shard implementation.
* **Pre-encoded bodies** — ``put`` serializes the payload once
  (``json.dumps(...).encode()``) and keeps the bytes next to the parsed
  dict; ``get_with_body`` hands both back so a cache hit writes
  pre-encoded bytes straight to the socket with no re-``json.dumps``.
  Payloads that aren't JSON-serializable simply carry no body
  (``None``) and callers fall back to the parsed form.
"""
from __future__ import annotations

import itertools
import json
import threading
import zlib
from collections import OrderedDict
from time import perf_counter
from typing import Any

from metis_tpu_torch.core.trace import Counters
from metis_tpu_torch.obs.metrics import NULL_METRICS, MetricsRegistry

# serve.cache.* counter suffix -> exported Prometheus counter name
_METRIC_NAMES = {
    "hit": "metis_serve_cache_hits_total",
    "miss": "metis_serve_cache_misses_total",
    "evict": "metis_serve_cache_evictions_total",
    "invalidate": "metis_serve_cache_invalidations_total",
}


def _encode(payload: dict) -> bytes | None:
    try:
        return json.dumps(payload).encode("utf-8")
    except (TypeError, ValueError):
        return None


class _Shard:
    """One lock + recency-ordered segment.  ``entries`` maps key ->
    ``[payload, body, stamp]`` and is kept in ascending-stamp order (the
    OrderedDict doubles as the shard-local LRU list)."""

    __slots__ = ("lock", "entries", "hits", "misses", "wait_hist")

    def __init__(self, wait_hist):
        self.lock = threading.Lock()
        self.entries: OrderedDict[str, list] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.wait_hist = wait_hist

    def acquire(self):
        # fast path: uncontended acquire costs no clock read; only a
        # blocked acquire pays for timing the wait
        if self.lock.acquire(blocking=False):
            return
        t0 = perf_counter()
        self.lock.acquire()
        self.wait_hist.observe((perf_counter() - t0) * 1000.0)


class PlanCache:
    """Bounded, shard-locked LRU mapping query fingerprint -> payload."""

    def __init__(self, capacity: int = 128,
                 counters: Counters | None = None,
                 metrics: MetricsRegistry = NULL_METRICS,
                 shards: int = 1):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        self.capacity = capacity
        self.counters = counters
        self.metrics = metrics
        self.metrics.gauge("metis_serve_cache_capacity").set(capacity)
        self._occupancy = self.metrics.gauge("metis_serve_cache_entries")
        self._stamp = itertools.count(1)
        self._size = 0
        self._size_lock = threading.Lock()
        self._shards = [
            _Shard(self.metrics.histogram(
                "metis_serve_cache_shard_lock_wait_ms", shard=str(i)))
            for i in range(shards)
        ]
        # optional callable(key) fired (outside any lock) once per entry
        # dropped by invalidate/invalidate_where/invalidate_all — how the
        # daemon's oplog records every invalidation uniformly, whichever
        # path (drift alarm, cluster delta, operator) caused it.  LRU
        # *evictions* do not fire it: eviction is capacity management,
        # not a state decision, and replaying one would be wrong.
        self.on_invalidate = None

    @property
    def num_shards(self) -> int:
        return len(self._shards)

    def _shard_for(self, key: str) -> _Shard:
        if len(self._shards) == 1:
            return self._shards[0]
        return self._shards[zlib.crc32(key.encode("utf-8"))
                            % len(self._shards)]

    def _inc(self, name: str, n: int = 1) -> None:
        if n <= 0:
            return
        if self.counters is not None:
            self.counters.inc(f"serve.cache.{name}", n)
        self.metrics.counter(_METRIC_NAMES[name]).inc(n)

    # -- lookups -------------------------------------------------------------
    def get(self, key: str) -> dict | None:
        """Payload for ``key`` (refreshing its recency), or None."""
        hit = self.get_with_body(key)
        return None if hit is None else hit[0]

    def get_with_body(self, key: str) -> tuple[dict, bytes | None] | None:
        """``(payload, pre-encoded JSON bytes | None)`` for a hit — one
        lookup, one hit/miss account.  The daemon's zero-copy path wants
        the bytes; everything else keeps using :meth:`get`."""
        shard = self._shard_for(key)
        shard.acquire()
        try:
            slot = shard.entries.get(key)
            if slot is None:
                shard.misses += 1
                payload = None
            else:
                shard.entries.move_to_end(key)
                slot[2] = next(self._stamp)
                shard.hits += 1
                payload, body = slot[0], slot[1]
        finally:
            shard.lock.release()
        if payload is None:
            self._inc("miss")
            return None
        self._inc("hit")
        return payload, body

    # -- mutation ------------------------------------------------------------
    def put(self, key: str, payload: dict) -> None:
        """Insert/refresh ``key``, evicting globally-LRU entries beyond
        the (global) capacity."""
        body = _encode(payload)
        shard = self._shard_for(key)
        shard.acquire()
        try:
            fresh = key not in shard.entries
            shard.entries[key] = [payload, body, next(self._stamp)]
            shard.entries.move_to_end(key)
        finally:
            shard.lock.release()
        with self._size_lock:
            if fresh:
                self._size += 1
            size = self._size
        evicted = 0
        while size > self.capacity:
            if not self._evict_oldest():
                break
            evicted += 1
            with self._size_lock:
                size = self._size
        self._occupancy.set(size)
        self._inc("evict", evicted)

    def _evict_oldest(self) -> bool:
        """Drop the globally least-recently-used entry (the minimum
        access stamp across shard heads).  Never holds two shard locks
        at once: heads are peeked one shard at a time, then the victim
        shard is re-locked to pop — a concurrent refresh of the peeked
        head just means we evict that shard's new head, still the
        oldest entry it holds."""
        victim: _Shard | None = None
        oldest = None
        for shard in self._shards:
            shard.acquire()
            try:
                if shard.entries:
                    stamp = next(iter(shard.entries.values()))[2]
                    if oldest is None or stamp < oldest:
                        oldest, victim = stamp, shard
            finally:
                shard.lock.release()
        if victim is None:
            return False
        victim.acquire()
        try:
            if not victim.entries:
                return False
            victim.entries.popitem(last=False)
        finally:
            victim.lock.release()
        with self._size_lock:
            self._size -= 1
        return True

    def invalidate(self, key: str) -> bool:
        """Drop one entry; True when it existed."""
        shard = self._shard_for(key)
        shard.acquire()
        try:
            existed = shard.entries.pop(key, None) is not None
        finally:
            shard.lock.release()
        if existed:
            with self._size_lock:
                self._size -= 1
                self._occupancy.set(self._size)
            self._inc("invalidate")
            if self.on_invalidate is not None:
                self.on_invalidate(key)
        return existed

    def invalidate_where(self, predicate) -> list[str]:
        """Drop every entry whose (key, payload) satisfies ``predicate``;
        returns the dropped keys — how a drift alarm clears exactly the
        queries whose cached best plan went stale.  Visits every shard."""
        doomed: list[str] = []
        for shard in self._shards:
            shard.acquire()
            try:
                dead = [k for k, slot in shard.entries.items()
                        if predicate(k, slot[0])]
                for k in dead:
                    del shard.entries[k]
            finally:
                shard.lock.release()
            doomed.extend(dead)
        if doomed:
            with self._size_lock:
                self._size -= len(doomed)
                self._occupancy.set(self._size)
        self._inc("invalidate", len(doomed))
        for k in doomed:
            if self.on_invalidate is not None:
                self.on_invalidate(k)
        return doomed

    def invalidate_all(self) -> int:
        """Drop everything (cluster topology changed); returns the count."""
        doomed: list[str] = []
        for shard in self._shards:
            shard.acquire()
            try:
                doomed.extend(shard.entries)
                shard.entries.clear()
            finally:
                shard.lock.release()
        with self._size_lock:
            self._size = 0
        self._occupancy.set(0)
        self._inc("invalidate", len(doomed))
        for k in doomed:
            if self.on_invalidate is not None:
                self.on_invalidate(k)
        return len(doomed)

    # -- snapshots -----------------------------------------------------------
    def __len__(self) -> int:
        with self._size_lock:
            return self._size

    def __contains__(self, key: str) -> bool:
        shard = self._shard_for(key)
        with shard.lock:
            return key in shard.entries

    def _sorted_slots(self) -> list[tuple[str, list]]:
        pairs: list[tuple[int, str, list]] = []
        for shard in self._shards:
            shard.acquire()
            try:
                pairs.extend((slot[2], k, slot)
                             for k, slot in shard.entries.items())
            finally:
                shard.lock.release()
        pairs.sort(key=lambda p: p[0])
        return [(k, slot) for _, k, slot in pairs]

    def keys(self) -> list[str]:
        """Snapshot of keys, globally LRU-first (eviction order)."""
        return [k for k, _ in self._sorted_slots()]

    def items(self) -> list[list]:
        """``[key, payload]`` pairs globally LRU-first, with NO side
        effects — no recency refresh, no hit/miss accounting.  The
        snapshot capture path uses this: re-``put``-ing the pairs in
        this order into an empty cache reproduces both contents and
        eviction order, for any shard count on either side."""
        return [[k, slot[0]] for k, slot in self._sorted_slots()]

    def shard_stats(self) -> list[dict[str, int]]:
        """Per-shard size/hit/miss snapshot — the reconciliation oracle:
        ``sum(s["hits"])`` must equal the ``serve.cache.hit`` counter."""
        out = []
        for shard in self._shards:
            shard.acquire()
            try:
                out.append({"size": len(shard.entries),
                            "hits": shard.hits,
                            "misses": shard.misses})
            finally:
                shard.lock.release()
        return out

    def stats(self) -> dict[str, Any]:
        counters = self.counters.as_dict() if self.counters else {}
        return {
            "size": len(self),
            "capacity": self.capacity,
            "shards": self.num_shards,
            "hits": counters.get("serve.cache.hit", 0),
            "misses": counters.get("serve.cache.miss", 0),
            "evictions": counters.get("serve.cache.evict", 0),
            "invalidations": counters.get("serve.cache.invalidate", 0),
        }
