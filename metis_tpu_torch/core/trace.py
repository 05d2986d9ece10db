"""Flight-recorder observability: hierarchical spans, counters, heartbeats.

The port's copy of ``metis_tpu/core/trace.py``.

The structured layer over :mod:`metis_tpu_torch.core.events` (spans,
counters and heartbeats for the search inner loops, the cost estimator,
the execution layer, the profiler and the bench).  Three primitives, all
draining to the same JSONL sink so a disabled log stays a no-op:

- **Spans** (:meth:`Tracer.span`): context-managed, monotonic-clock
  durations, parent/child nesting, per-span attributes.  ``span_begin`` is
  emitted at entry and ``span_end`` (with ``dur_ms``) at exit, so a crashed
  run's tail still shows which phase was open.  For phases whose work is
  interleaved with other phases inside one loop (enumeration vs costing in
  ``plan_hetero``), :meth:`Tracer.accum` gives an *accumulating* span: a
  re-enterable context manager that tallies total time and entry count and
  emits ONE ``span_end`` when closed.
- **Counters** (:class:`Counters`): a plain name->int registry for search
  accounting (candidates enumerated/costed/pruned per family, profile
  misses, bandwidth-cache hits); flushed as a single ``counters`` event.
- **Heartbeats** (:class:`Heartbeat`): a periodic progress event every N
  ticks (candidates/sec, best-cost-so-far, elapsed) so a long search is
  observable *while running* (``tail -f`` the events file).

``build_span_tree`` / ``render_span_table`` / ``span_tree_json`` reconstruct
and render the recorded tree — the engine behind ``metis-tpu report``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any

from metis_tpu_torch.core.events import EventLog, NULL_LOG


class Counters:
    """Monotonic named counters.  ``inc`` is a dict add — cheap enough for
    per-candidate accounting in search loops; pass ``None`` instead of a
    Counters to instrumented code when tracing is off to skip even that.

    Thread-safe: the serve daemon shares one registry across request
    threads, and the read-modify-write in ``inc`` is not atomic under
    threads, so a lock covers every mutation and snapshot."""

    __slots__ = ("_c", "_lock")

    def __init__(self) -> None:
        self._c: dict[str, int] = {}
        self._lock = threading.Lock()

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c[name] = self._c.get(name, 0) + n

    def get(self, name: str) -> int:
        with self._lock:
            return self._c.get(name, 0)

    def merge(self, other: dict[str, int]) -> None:
        """Fold another run's counter dict into this registry — how the
        parallel search parent (search/parallel.py) reconciles per-worker
        accounting into the one ``counters`` event the run emits."""
        with self._lock:
            for name, n in other.items():
                self._c[name] = self._c.get(name, 0) + n

    def as_dict(self) -> dict[str, int]:
        with self._lock:
            return dict(self._c)

    def __bool__(self) -> bool:
        return bool(self._c)


class _NullSpan:
    """Shared no-op stand-in for spans and accum-spans on a disabled
    tracer: re-enterable, closeable, attribute-settable, all free."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        pass

    def close(self) -> None:
        pass


NULL_SPAN = _NullSpan()


class Span:
    """One timed region.  Use via ``with tracer.span(name, **attrs):``."""

    __slots__ = ("_tracer", "name", "path", "span_id", "parent_id", "attrs",
                 "_t0", "_accums")

    def __init__(self, tracer: "Tracer", name: str, **attrs: Any):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id = tracer._next_id()
        parent = tracer._stack[-1] if tracer._stack else None
        self.parent_id = parent.span_id if parent is not None else None
        self.path = (f"{parent.path}/{name}" if parent is not None else name)
        self._t0 = 0.0
        self._accums: list[AccumSpan] = []

    def set(self, **attrs: Any) -> None:
        """Attach attributes after entry; they ride on ``span_end``."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        self._tracer._stack.append(self)
        self._tracer.events.emit(
            "span_begin", name=self.name, span_id=self.span_id,
            parent_id=self.parent_id, path=self.path,
            **self.attrs)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: object) -> bool:
        dur_ms = (time.perf_counter() - self._t0) * 1e3
        # a forgotten accumulating child must not vanish from the tree
        for acc in self._accums:
            acc.close()
        stack = self._tracer._stack
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer.events.emit(
            "span_end", name=self.name, span_id=self.span_id,
            parent_id=self.parent_id, path=self.path,
            dur_ms=round(dur_ms, 3), **self.attrs)
        return False


class AccumSpan:
    """Accumulating span for phases interleaved inside one loop: re-enter
    with ``with acc:`` any number of times; ``close()`` (or the parent
    span's exit) emits one ``span_end`` with the total duration and the
    entry count.  Non-reentrant — sequential tallies only."""

    __slots__ = ("_tracer", "name", "path", "span_id", "parent_id", "attrs",
                 "total_s", "count", "_t0", "_closed")

    def __init__(self, tracer: "Tracer", name: str, **attrs: Any):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id = tracer._next_id()
        parent = tracer._stack[-1] if tracer._stack else None
        self.parent_id = parent.span_id if parent is not None else None
        self.path = (f"{parent.path}/{name}" if parent is not None else name)
        if parent is not None:
            parent._accums.append(self)
        self.total_s = 0.0
        self.count = 0
        self._t0 = 0.0
        self._closed = False
        tracer.events.emit(
            "span_begin", name=name, span_id=self.span_id,
            parent_id=self.parent_id, path=self.path, **attrs)

    def __enter__(self) -> "AccumSpan":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: object) -> bool:
        self.total_s += time.perf_counter() - self._t0
        self.count += 1
        return False

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._tracer.events.emit(
            "span_end", name=self.name, span_id=self.span_id,
            parent_id=self.parent_id, path=self.path,
            dur_ms=round(self.total_s * 1e3, 3), entries=self.count,
            **self.attrs)


class Tracer:
    """Span factory + counter registry bound to one EventLog.

    Construction is free; every method is a no-op when the log is disabled
    (``tracer.span(...)`` returns the shared :data:`NULL_SPAN`), so call
    sites never guard."""

    def __init__(self, events: EventLog = NULL_LOG):
        self.events = events
        self.counters = Counters()
        self._stack: list[Span] = []
        self._id = 0

    @property
    def enabled(self) -> bool:
        return self.events.enabled

    def _next_id(self) -> int:
        self._id += 1
        return self._id

    def span(self, name: str, **attrs: Any):
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, **attrs)

    def accum(self, name: str, **attrs: Any):
        if not self.enabled:
            return NULL_SPAN
        return AccumSpan(self, name, **attrs)

    def inc(self, name: str, n: int = 1) -> None:
        if self.enabled:
            self.counters.inc(name, n)

    def emit_counters(self, scope: str, **extra: Any) -> None:
        """Flush the counter registry as one ``counters`` event."""
        if self.enabled and (self.counters or extra):
            self.events.emit("counters", scope=scope,
                             counters=self.counters.as_dict(), **extra)


class Heartbeat:
    """Emit a progress event every ``every`` ticks.

    ``tick(n, **fields)`` advances by n; once the accumulated count crosses
    the next ``every`` boundary one event fires carrying the total count,
    elapsed seconds, the rate, and the caller's fields (best-cost-so-far
    etc.).  A disabled log ticks for free."""

    def __init__(self, events: EventLog, event: str = "search_progress",
                 every: int = 1000):
        self.events = events
        self.event = event
        self.every = max(int(every), 1)
        self._n = 0
        self._emitted_at = 0
        self._t0 = time.perf_counter()

    @property
    def n(self) -> int:
        return self._n

    def tick(self, n: int = 1, **fields: Any) -> None:
        if not self.events.enabled:
            return
        self._n += n
        if self._n - self._emitted_at < self.every:
            return
        self._emitted_at = self._n
        elapsed = time.perf_counter() - self._t0
        self.events.emit(
            self.event, n=self._n, elapsed_s=round(elapsed, 3),
            per_s=round(self._n / elapsed, 1) if elapsed > 0 else None,
            **fields)


def timed_iter(it, acc):
    """Route each ``next()`` of ``it`` through accumulating span ``acc`` —
    how lazy-generator phases (enumeration, intra expansion) get charged to
    their own span while the consuming loop interleaves them with costing."""
    sentinel = object()
    while True:
        with acc:
            item = next(it, sentinel)
        if item is sentinel:
            return
        yield item


# ---------------------------------------------------------------------------
# report: reconstruct and render the span tree from an event JSONL
# ---------------------------------------------------------------------------


@dataclass
class SpanNode:
    """One reconstructed span.  ``dur_ms`` is None for a span whose
    ``span_end`` never arrived (the run crashed with it open)."""

    name: str
    span_id: int
    parent_id: int | None
    path: str
    dur_ms: float | None = None
    entries: int | None = None
    attrs: dict = field(default_factory=dict)
    children: list["SpanNode"] = field(default_factory=list)

    @property
    def closed(self) -> bool:
        return self.dur_ms is not None

    @property
    def self_ms(self) -> float | None:
        if self.dur_ms is None:
            return None
        child = sum(c.dur_ms for c in self.children if c.dur_ms is not None)
        return max(self.dur_ms - child, 0.0)


_SPAN_META = ("ts", "event", "name", "span_id", "parent_id", "path",
              "dur_ms", "entries")


def build_span_tree(
    events: list[dict],
) -> tuple[list[SpanNode], dict[str, dict[str, int]]]:
    """(roots, counters-by-scope) from parsed event dicts.

    ``span_begin`` creates nodes (so crashed-open spans still appear),
    ``span_end`` fills durations; every other event type is ignored except
    ``counters``, which are merged per scope."""
    nodes: dict[int, SpanNode] = {}
    counters: dict[str, dict[str, int]] = {}
    for ev in events:
        kind = ev.get("event")
        if kind == "counters":
            scope = ev.get("scope", "")
            merged = counters.setdefault(scope, {})
            for k, v in (ev.get("counters") or {}).items():
                merged[k] = merged.get(k, 0) + v
        if kind not in ("span_begin", "span_end"):
            continue
        sid = ev.get("span_id")
        if sid is None:
            continue
        node = nodes.get(sid)
        if node is None:
            node = SpanNode(name=ev.get("name", "?"), span_id=sid,
                            parent_id=ev.get("parent_id"),
                            path=ev.get("path", ev.get("name", "?")))
            nodes[sid] = node
        if kind == "span_end":
            node.dur_ms = ev.get("dur_ms")
            node.entries = ev.get("entries")
        node.attrs.update(
            {k: v for k, v in ev.items() if k not in _SPAN_META})
    roots: list[SpanNode] = []
    for node in nodes.values():  # insertion order = event order
        parent = nodes.get(node.parent_id) if node.parent_id is not None \
            else None
        if parent is not None:
            parent.children.append(node)
        else:
            roots.append(node)
    return roots, counters


def filter_top_spans(roots: list[SpanNode], n: int) -> list[SpanNode]:
    """Prune a span tree to its ``n`` most expensive spans by self-time
    (``metis-tpu report --top N``).

    Ancestors of a kept span are kept for context, and open spans (no
    ``span_end`` — the crash signal) are always kept regardless of rank.
    The input nodes are not mutated; pruned copies are returned.
    """
    flat: list[tuple[SpanNode, tuple[SpanNode, ...]]] = []

    def walk(node: SpanNode, ancestors: tuple[SpanNode, ...]) -> None:
        flat.append((node, ancestors))
        for c in node.children:
            walk(c, ancestors + (node,))

    for r in roots:
        walk(r, ())
    closed = sorted((nd for nd, _ in flat if nd.dur_ms is not None),
                    key=lambda nd: -(nd.self_ms or 0.0))
    keep = {id(nd) for nd in closed[:max(n, 0)]}
    keep |= {id(nd) for nd, _ in flat if nd.dur_ms is None}  # crashed-open
    for nd, ancestors in flat:
        if id(nd) in keep:
            keep |= {id(a) for a in ancestors}

    def prune(node: SpanNode) -> SpanNode:
        copy = SpanNode(name=node.name, span_id=node.span_id,
                        parent_id=node.parent_id, path=node.path,
                        dur_ms=node.dur_ms, entries=node.entries,
                        attrs=dict(node.attrs))
        copy.children = [prune(c) for c in node.children if id(c) in keep]
        return copy

    return [prune(r) for r in roots if id(r) in keep]


def span_tree_json(roots: list[SpanNode],
                   counters: dict[str, dict[str, int]]) -> dict:
    def node_dict(n: SpanNode) -> dict:
        d: dict[str, Any] = {"name": n.name, "path": n.path,
                             "dur_ms": n.dur_ms, "self_ms": n.self_ms,
                             "closed": n.closed}
        if n.entries is not None:
            d["entries"] = n.entries
        if n.attrs:
            d["attrs"] = n.attrs
        if n.children:
            d["children"] = [node_dict(c) for c in n.children]
        return d

    return {"spans": [node_dict(r) for r in roots], "counters": counters}


def render_span_table(roots: list[SpanNode],
                      counters: dict[str, dict[str, int]]) -> str:
    """Human table: one row per span (indent = depth), duration, self time,
    percent of its root, entry counts; counter scopes appended below."""
    rows: list[tuple[str, str, str, str, str]] = []

    def walk(n: SpanNode, depth: int, root_ms: float | None) -> None:
        label = "  " * depth + n.name
        if n.dur_ms is None:
            dur = self_t = "?"
            pct = "open"  # crashed/unclosed span
        else:
            dur = f"{n.dur_ms:.1f}"
            self_t = f"{n.self_ms:.1f}"
            pct = (f"{100.0 * n.dur_ms / root_ms:.1f}"
                   if root_ms else "100.0")
        rows.append((label, dur, self_t, pct,
                     str(n.entries) if n.entries is not None else ""))
        for c in n.children:
            walk(c, depth + 1, root_ms if root_ms else n.dur_ms)

    for r in roots:
        walk(r, 0, r.dur_ms)
    header = ("span", "dur_ms", "self_ms", "%", "n")
    widths = [max(len(h), *(len(row[i]) for row in rows)) if rows else len(h)
              for i, h in enumerate(header)]
    lines = [
        "  ".join(h.ljust(widths[i]) for i, h in enumerate(header)),
        "  ".join("-" * widths[i] for i in range(len(header))),
    ]
    for row in rows:
        lines.append("  ".join(
            row[i].ljust(widths[i]) for i in range(len(row))).rstrip())
    for scope in sorted(counters):
        lines.append("")
        lines.append(f"counters [{scope}]")
        for k in sorted(counters[scope]):
            lines.append(f"  {k} = {counters[scope][k]}")
    return "\n".join(lines)
