"""Structured JSONL event log — the port's copy of
``metis_tpu/core/events.py`` (``EventLog``, ``NULL_LOG``, ``read_events``).

One JSON object per line, wall-clock stamped, safe to tail.  A disabled log
(no sink) is a no-op so call sites never guard.
"""
from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import IO, Any


class EventLog:
    """Append-only JSONL sink.  ``EventLog(path)`` writes to a file,
    ``EventLog(stream=...)`` to any text stream, ``EventLog()`` discards.

    The file opens lazily on first emit and stays open, line-buffered;
    ``close()`` (or use as a context manager) releases it.  One lock covers
    open/write/close, so emits from several threads never tear a line."""

    def __init__(self, path: str | Path | None = None,
                 stream: IO[str] | None = None):
        if path is not None and stream is not None:
            raise ValueError("pass either path or stream, not both")
        self._stream: IO[str] | None = stream
        self._path = Path(path) if path is not None else None
        self._fh: IO[str] | None = None
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self._path is not None or self._stream is not None

    def emit(self, event: str, **fields: Any) -> None:
        if not self.enabled:
            return
        record = {"ts": time.time(), "event": event, **fields}
        line = json.dumps(record, default=str) + "\n"
        with self._lock:
            if self._stream is not None:
                self._stream.write(line)
                self._stream.flush()
                return
            if self._fh is None:
                self._fh = open(self._path, "a", buffering=1)
            self._fh.write(line)

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


NULL_LOG = EventLog()


def read_events(path: str | Path) -> list[dict]:
    """Parse a JSONL event file back into dicts."""
    return [json.loads(line) for line in Path(path).read_text().splitlines()
            if line.strip()]
