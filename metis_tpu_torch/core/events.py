"""Structured JSONL event log.

The port's copy of ``metis_tpu/core/events.py``.

SURVEY.md §5 "Metrics / logging": the reference observes itself with bare
``print()`` calls redirected to a log file by its bash wrapper.  This is the
machine-readable replacement: one JSON object per line, wall-clock stamped,
safe to tail.  A disabled log (no sink) is a no-op so call sites never guard.
"""
from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import IO, Any


class EventLog:
    """Append-only JSONL sink.  ``EventLog(path)`` writes to a file,
    ``EventLog(stream=...)`` to any text stream, ``EventLog()`` discards.

    The file handle opens lazily on first emit and stays open (line-buffered
    append) — span/heartbeat instrumentation emits from search inner loops,
    where an open() per event would cost O(events) syscalls.  Line buffering
    keeps every record tail-able the moment it is written; ``close()`` (or
    use as a context manager) releases the handle.

    ``max_bytes`` bounds a long-lived daemon's log: when an emit would push
    the file past the limit, the current file rolls to ``<name>.1``
    (replacing any previous roll) and the fresh file opens with an
    ``event_log_rotated`` record as its first line — so a reader of the
    live file always knows a predecessor exists.  Rotation happens inside
    the emit lock; concurrent emitters never see a closed handle.

    Thread-safe: the serve daemon emits from many request threads into one
    log, and a torn write would corrupt the JSONL contract that
    tools/check_events_schema.py enforces, so one lock covers open/write/
    flush/close."""

    def __init__(self, path: str | Path | None = None,
                 stream: IO[str] | None = None,
                 max_bytes: int | None = None):
        self._stream: IO[str] | None = stream
        self._path = Path(path) if path is not None else None
        self._fh: IO[str] | None = None
        self._lock = threading.Lock()
        if self._path is not None and stream is not None:
            raise ValueError("pass either path or stream, not both")
        if max_bytes is not None and max_bytes <= 0:
            raise ValueError("max_bytes must be positive")
        self._max_bytes = max_bytes if self._path is not None else None

    @property
    def enabled(self) -> bool:
        return self._path is not None or self._stream is not None

    def with_fields(self, **fields: Any) -> "EventLog":
        """A view of this log that stamps ``fields`` onto every emit —
        how the serve daemon threads one request's ``trace_id`` through
        every span, event, and background thread it causes.  Views share
        the parent's handle and lock; a disabled log returns itself."""
        if not self.enabled or not fields:
            return self
        return BoundEventLog(self, fields)

    def emit(self, event: str, **fields: Any) -> None:
        if not self.enabled:
            return
        record = {"ts": time.time(), "event": event, **fields}
        line = json.dumps(record, default=str) + "\n"
        with self._lock:
            if self._stream is not None:
                self._stream.write(line)
                self._stream.flush()
            else:
                if self._fh is None:
                    self._fh = open(self._path, "a", buffering=1)
                if self._max_bytes is not None:
                    self._maybe_rotate(len(line))
                self._fh.write(line)

    def _maybe_rotate(self, pending: int) -> None:
        """Roll the live file to ``.1`` when the next write would cross
        ``max_bytes``.  Caller holds the lock and has opened ``_fh``."""
        size = self._fh.tell()
        if size == 0 or size + pending <= self._max_bytes:
            return
        self._fh.close()
        rolled = self._path.with_name(self._path.name + ".1")
        os.replace(self._path, rolled)
        self._fh = open(self._path, "a", buffering=1)
        first = {"ts": time.time(), "event": "event_log_rotated",
                 "rotated_to": str(rolled), "size_bytes": size}
        self._fh.write(json.dumps(first, default=str) + "\n")

    def close(self) -> None:
        """Release the held file handle (emit after close reopens it)."""
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc: object) -> bool:
        self.close()
        return False

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:  # interpreter teardown — nothing left to do
            pass


class BoundEventLog(EventLog):
    """An :class:`EventLog` view with fields pre-bound (see
    :meth:`EventLog.with_fields`).  Delegates every emit to the parent, so
    the parent's lock, lazy handle, and rotation policy apply unchanged;
    caller-supplied fields win over bound ones on collision.  ``close`` is
    a no-op — the parent owns the handle."""

    def __init__(self, parent: EventLog, fields: dict[str, Any]):
        self._parent = parent
        self._fields = dict(fields)

    @property
    def enabled(self) -> bool:
        return self._parent.enabled

    def with_fields(self, **fields: Any) -> "EventLog":
        if not fields:
            return self
        return BoundEventLog(self._parent, {**self._fields, **fields})

    def emit(self, event: str, **fields: Any) -> None:
        self._parent.emit(event, **{**self._fields, **fields})

    def close(self) -> None:
        pass

    def __del__(self) -> None:
        pass


NULL_LOG = EventLog()


def read_events(path: str | Path) -> list[dict]:
    """Parse a JSONL event file back into dicts."""
    out = []
    for line in Path(path).read_text().splitlines():
        if line.strip():
            out.append(json.loads(line))
    return out


def read_events_rotated(path: str | Path) -> list[dict]:
    """Like :func:`read_events`, but prepends the ``<name>.1`` roll when
    size-based rotation (``EventLog(max_bytes=...)``) displaced earlier
    records there — so trace and causal-chain reconstruction over a
    long-lived daemon's log sees the full history, not just the live
    file.  The rolled file's records come first (they are strictly older);
    a missing roll degrades to a plain read."""
    p = Path(path)
    rolled = p.with_name(p.name + ".1")
    out: list[dict] = []
    if rolled.exists():
        out.extend(read_events(rolled))
    out.extend(read_events(p))
    return out
