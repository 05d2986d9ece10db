"""Durable control-plane state: snapshots + oplog for the serve daemon —
the port of ``metis_tpu/serve/persist.py``.  The snapshot and oplog
formats are the reference's, field for field (canonical JSON), so a state
directory written by either package's daemon restores in the other.

The daemon (``serve/daemon.py``) is production infrastructure — the front
door for plan queries, fleet scheduling, drift replans — yet before this
module every byte of its logical state lived in one process's memory: one
SIGKILL and every tenant cold-started.  Two complementary durability
primitives close that gap:

- :class:`SnapshotStore` — a versioned, atomic, sha256-digest-verified
  snapshot of the daemon's full logical state.  Same crash-safety idiom
  as ``execution/checkpoint.py``: the new snapshot is fully written to a
  ``.tmp`` sibling, the previous generation is parked at ``.prev``, and
  the swap is a rename — at every instant one complete, verified
  snapshot is on disk.  A corrupt (truncated / bit-flipped) primary
  falls back to ``.prev`` on load; corruption is reported as
  :class:`~metis_tpu_torch.core.errors.SnapshotCorruptError`, never as a raw
  deserialization traceback, and wins over "missing" in error reporting.
- :class:`Oplog` — an append-only, sequence-numbered JSONL of every
  state mutation (plan insert, invalidation, tenant register/remove,
  cluster delta, notification push).  Appends are line-buffered writes:
  each line reaches the kernel before the call returns, so the log
  survives a ``kill -9`` of the daemon (fsync is deliberately omitted —
  the drill's failure model is process death, not power loss).  A
  torn trailing line from a mid-write crash is skipped on load.

Restore = load the latest good snapshot, then replay the oplog tail
(entries with ``seq`` greater than the snapshot's cursor).  Every op is
**absolute** — it carries the resulting state, not a diff — so replay is
idempotent and the snapshot/oplog race window (an op landing between the
cursor capture and the state capture) self-heals.

The same :func:`apply_entry` that replays a restore tail also drives the
standby daemon (``serve/standby.py``), which tails ``GET /oplog`` and
applies entries to its own state — one code path, so a promoted standby
is byte-identical to a restored primary by construction.

Import discipline: the daemon imports this module; the capture/restore
helpers therefore never import ``serve.daemon`` at module scope (they
take the live service object and duck-type it).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import IO, Any

from metis_tpu_torch.core.errors import SnapshotCorruptError

SNAPSHOT_VERSION = 1
SNAPSHOT_FILE = "state.json"
OPLOG_FILE = "oplog.jsonl"


def _canonical(payload: Any) -> str:
    return json.dumps(payload, sort_keys=True, separators=(",", ":"),
                      default=str)


def payload_digest(payload: Any) -> str:
    """sha256 of the canonical JSON form — what :class:`SnapshotStore`
    records at write and verifies at load.  Canonicalization makes the
    digest stable across the JSON round-trip (load + re-dump of the
    payload reproduces the same bytes)."""
    return hashlib.sha256(_canonical(payload).encode()).hexdigest()


class SnapshotStore:
    """Atomic, digest-verified, two-generation snapshot file.

    Layout under ``state_dir``: ``state.json`` (current), ``state.json.prev``
    (previous generation, retained across every write), ``state.json.tmp``
    (in-flight write; a leftover tmp marks a mid-write crash and is
    ignored by :meth:`load`).
    """

    def __init__(self, state_dir: str | Path):
        self.dir = Path(state_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / SNAPSHOT_FILE
        self.prev = self.path.with_suffix(self.path.suffix + ".prev")
        self.tmp = self.path.with_suffix(self.path.suffix + ".tmp")
        # ts/bytes of the last successful write (or of the loaded
        # snapshot) — what the snapshot age/size gauges report
        self.last_ts: float | None = None
        self.last_bytes: int = 0

    def write(self, payload: dict) -> dict:
        """Atomically persist ``payload``; returns the written document's
        meta (``ts``/``digest``/``bytes``).  Write order is the checkpoint
        idiom: tmp first (complete + flushed), park the primary at
        ``.prev``, rename tmp into place — a crash at any instant leaves
        at least one complete generation on disk."""
        doc = {
            "version": SNAPSHOT_VERSION,
            "ts": time.time(),
            "digest": payload_digest(payload),
            "payload": payload,
        }
        body = json.dumps(doc, default=str)
        with open(self.tmp, "w") as fh:
            fh.write(body)
            fh.flush()
            os.fsync(fh.fileno())
        if self.path.exists():
            os.replace(self.path, self.prev)
        os.replace(self.tmp, self.path)
        self.last_ts = doc["ts"]
        self.last_bytes = len(body)
        return {"ts": doc["ts"], "digest": doc["digest"],
                "bytes": len(body)}

    def _load_one(self, path: Path) -> dict:
        try:
            doc = json.loads(path.read_text())
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise SnapshotCorruptError(
                f"snapshot {path} is not valid JSON (truncated or "
                f"corrupt): {e}") from e
        if not isinstance(doc, dict) or "payload" not in doc:
            raise SnapshotCorruptError(
                f"snapshot {path} has no payload — not a snapshot file")
        if int(doc.get("version", 0)) > SNAPSHOT_VERSION:
            raise SnapshotCorruptError(
                f"snapshot {path} has version {doc.get('version')} but "
                f"this build reads <= {SNAPSHOT_VERSION}")
        digest = payload_digest(doc["payload"])
        if digest != doc.get("digest"):
            raise SnapshotCorruptError(
                f"snapshot {path}: sha256 digest mismatch "
                f"(recorded {doc.get('digest')!r:.20}..., "
                f"recomputed {digest[:16]}...) — the file is corrupt")
        return doc

    def load(self) -> dict | None:
        """The latest verified snapshot document, falling back to
        ``.prev`` when the primary is corrupt or missing.  Returns None
        when no generation exists at all; raises
        :class:`SnapshotCorruptError` when generations exist but none
        verifies — corruption wins over absence, so a daemon never
        silently cold-starts on top of a damaged state dir."""
        corrupt: SnapshotCorruptError | None = None
        for path, source in ((self.path, "latest"), (self.prev, "prev")):
            if not path.exists():
                continue
            try:
                doc = self._load_one(path)
            except SnapshotCorruptError as e:
                if corrupt is None:
                    corrupt = e
                continue
            doc["source"] = source
            self.last_ts = float(doc.get("ts") or 0.0) or None
            self.last_bytes = len(json.dumps(doc, default=str))
            return doc
        if corrupt is not None:
            raise corrupt
        return None


class Oplog:
    """Append-only JSONL of state-mutation ops, kept fully in memory for
    ``GET /oplog?since=N`` serving.  One line per entry, line-buffered —
    the write reaches the kernel before :meth:`append` returns, so the
    log is exactly as durable as the process's last completed call even
    under ``kill -9``.  Thread-safe."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._lock = threading.Lock()
        self._fh: IO[str] | None = None
        self._entries: list[dict] = []
        self.last_seq = 0
        # seq below which entries are no longer held (always 0 for an
        # uncompacted log) — the gap signal /oplog reports so a reader
        # that fell behind knows to re-bootstrap from a snapshot
        self.oldest_seq = 0
        if self.path.exists():
            self._load()

    def _load(self) -> None:
        for line in self.path.read_text().splitlines():
            if not line.strip():
                continue
            try:
                entry = json.loads(line)
                seq = int(entry["seq"])
            except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                # torn trailing line from a mid-write crash (or stray
                # garbage): the entries before it are intact, keep them
                continue
            self._entries.append(entry)
            self.last_seq = max(self.last_seq, seq)

    def append(self, entry: dict) -> None:
        with self._lock:
            if self._fh is None:
                self._fh = open(self.path, "a", buffering=1)
            self._fh.write(json.dumps(entry, default=str) + "\n")
            self._entries.append(entry)
            self.last_seq = max(self.last_seq, int(entry["seq"]))

    def entries(self, since: int = 0) -> list[dict]:
        """Entries with ``seq > since``, oldest first."""
        with self._lock:
            return [e for e in self._entries if int(e["seq"]) > since]

    @property
    def first_seq(self) -> int | None:
        """Seq of the oldest held entry (None when empty)."""
        with self._lock:
            return int(self._entries[0]["seq"]) if self._entries else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# ---------------------------------------------------------------------------
# daemon state <-> JSON payload
# ---------------------------------------------------------------------------


def query_record_to_dict(rec) -> dict:
    """Serialize a ``serve.daemon._QueryRecord`` (duck-typed)."""
    return {
        "model": dataclasses.asdict(rec.model),
        "config": dataclasses.asdict(rec.config),
        "top_k": rec.top_k,
        "key": rec.key,
        "plan_fingerprint": rec.plan_fingerprint,
        "workload": (dataclasses.asdict(rec.workload)
                     if rec.workload is not None else None),
        "plan_layout": ([list(t) for t in rec.plan_layout]
                        if rec.plan_layout is not None else None),
        "node_id_set": (sorted(rec.node_id_set)
                        if rec.node_id_set is not None else None),
        "decision_seq": rec.decision_seq,
    }


def query_record_from_dict(d: dict):
    from metis_tpu_torch.inference.workload import workload_from_dict
    from metis_tpu_torch.serve.daemon import (
        _QueryRecord,
        model_spec_from_dict,
        search_config_from_dict,
    )

    wl = d.get("workload")
    layout = d.get("plan_layout")
    nodes = d.get("node_id_set")
    return _QueryRecord(
        model=model_spec_from_dict(d["model"]),
        config=search_config_from_dict(d["config"]),
        top_k=d.get("top_k"),
        key=d["key"],
        plan_fingerprint=d.get("plan_fingerprint"),
        workload=workload_from_dict(wl) if wl else None,
        plan_layout=(tuple(tuple(t) for t in layout)
                     if layout is not None else None),
        node_id_set=frozenset(nodes) if nodes is not None else None,
        decision_seq=d.get("decision_seq"),
    )


def _monitor_to_dict(monitor) -> dict:
    det = monitor.detector
    return {
        "band_pct": det.band_pct,
        "min_samples": det.min_samples,
        "clear_pct": det.clear_pct,
        "window": det._errors.maxlen,
        "errors": list(det._errors),
        "in_drift": det.in_drift,
        "alarms": det.alarms,
        "skip_steps": monitor.skip_steps,
        "skipped": monitor._skipped,
        "source": monitor.source,
    }


def _monitor_from_dict(service, fingerprint: str, d: dict):
    from collections import deque as _deque

    from metis_tpu_torch.obs.ledger import AccuracyMonitor

    monitor = AccuracyMonitor(
        service.ledger, fingerprint, events=service.events,
        band_pct=float(d["band_pct"]),
        min_samples=int(d["min_samples"]),
        skip_steps=int(d.get("skip_steps", 0)),
        source=d.get("source", "serve"))
    monitor._skipped = int(d.get("skipped", 0))
    det = monitor.detector
    det.clear_pct = float(d["clear_pct"])
    det._errors = _deque((float(e) for e in d.get("errors", ())),
                         maxlen=int(d.get("window") or 32))
    det.in_drift = bool(d.get("in_drift", False))
    det.alarms = int(d.get("alarms", 0))
    return monitor


def capture_state(service) -> dict:
    """The daemon's full logical state as a JSON-serializable payload.

    The op-seq cursor is read FIRST: any mutation that lands while the
    rest of the state is being collected is therefore at a seq above the
    cursor and will be replayed on restore — replay is idempotent (ops
    are absolute), so the worst case is re-applying state the snapshot
    already caught, never losing state it missed.

    Deliberately not captured (derived or telemetry, documented in the
    README "Persistence & HA" section): warm search evaluators (rebuilt
    on demand), accuracy *measurements* (the drift window rides the
    monitor state; full history belongs in a ledger file), metric/counter
    values, and the single-flight table."""
    from metis_tpu_torch.planner.replan import ClusterDelta

    with service._note_cond:
        op_seq = service._note_seq
        notes = [dict(n) for n in service._notes]
        notes_dropped_high = service._notes_dropped_high
    delta = ClusterDelta.between(service.full_cluster, service.cluster)
    with service._lock:
        queries = {k: query_record_to_dict(r)
                   for k, r in service._queries.items()}
        applied_deltas = list(service._applied_deltas.items())
    with service._accuracy_lock:
        monitors = {fp: _monitor_to_dict(m)
                    for fp, m in service._monitors.items()}
        handled_alarms = dict(service._handled_alarms)
        predictions = {fp: dict(rec)
                       for fp, rec in service.ledger.predictions.items()}
    with service._search_lock:
        fleet = (service.sched.export_state()
                 if service.sched is not None else None)
    return {
        "op_seq": op_seq,
        "decision_seq": service.decisions.last_seq,
        "cluster": {"removed": delta.removed, "added": delta.added},
        "cache": service.cache.items(),
        "queries": queries,
        "notes": notes,
        "notes_dropped_high": notes_dropped_high,
        "monitors": monitors,
        "handled_alarms": handled_alarms,
        "predictions": predictions,
        "applied_deltas": applied_deltas,
        "fleet": fleet,
    }


def restore_state(service, payload: dict) -> None:
    """Rebuild the daemon's logical state from a snapshot payload.

    Runs during boot, before the service takes requests — no locking
    subtleties; the service's ``_replaying`` flag is already set by the
    caller so cache callbacks do not log fresh ops for restored state."""
    from collections import OrderedDict

    from metis_tpu_torch.planner.replan import ClusterDelta

    cl = payload.get("cluster") or {}
    delta = ClusterDelta(removed=dict(cl.get("removed", {})),
                         added=dict(cl.get("added", {})))
    if not delta.is_empty:
        service.cluster = delta.apply(service.full_cluster,
                                      full=service.full_cluster)
    for key, entry in payload.get("cache", []):
        service.cache.put(key, entry)
    service._queries = {k: query_record_from_dict(d)
                        for k, d in payload.get("queries", {}).items()}
    service._notes = [dict(n) for n in payload.get("notes", [])]
    service._notes_dropped_high = int(
        payload.get("notes_dropped_high", 0))
    service._note_seq = int(payload.get("op_seq", 0))
    service._handled_alarms = {
        fp: int(n)
        for fp, n in payload.get("handled_alarms", {}).items()}
    service.ledger.predictions.update(payload.get("predictions", {}))
    service._monitors = {
        fp: _monitor_from_dict(service, fp, d)
        for fp, d in payload.get("monitors", {}).items()}
    service._applied_deltas = OrderedDict(
        (str(k), dict(v))
        for k, v in payload.get("applied_deltas", []))
    fleet = payload.get("fleet")
    if fleet is not None:
        sched = service._ensure_sched()
        sched.restore_state(fleet)
        sched.cluster = service.cluster
    # the decision log resumes its own seq from its file when durable;
    # for an in-memory log the snapshot cursor keeps `GET /decisions`
    # seq numbering monotonic across the restart
    service.decisions.resume_seq(int(payload.get("decision_seq", 0)))


def apply_entry(service, entry: dict) -> None:
    """Apply one oplog entry to a service's state — the shared mutation
    path for restore-time replay (primary) and live replication
    (standby).  Every op is absolute, so applying an entry the state
    already reflects is a no-op; entries at or below the current cursor
    are skipped outright.

    The caller is responsible for setting ``service._replaying`` around
    batches (the daemon's restore loop and the standby's apply loop both
    do), so applied mutations never log fresh ops."""
    seq = int(entry["seq"])
    with service._note_cond:
        if seq <= service._note_seq:
            return
        service._note_seq = seq
    op = entry.get("op")
    if op == "plan_insert":
        service.cache.put(entry["key"], entry["entry"])
        q = entry.get("query")
        if q is not None:
            with service._lock:
                service._queries[entry["key"]] = query_record_from_dict(q)
    elif op == "plan_invalidate":
        # drop the cache entry only — the primary keeps its _QueryRecord
        # across invalidations (it is what drives the later replan), so a
        # replica must too.
        service.cache.invalidate(entry["key"])
    elif op in ("tenant_register", "tenant_remove", "cluster_delta"):
        from metis_tpu_torch.planner.replan import ClusterDelta

        cl = entry.get("cluster") or {}
        delta = ClusterDelta(removed=dict(cl.get("removed", {})),
                             added=dict(cl.get("added", {})))
        new_cluster = (delta.apply(service.full_cluster,
                                   full=service.full_cluster)
                       if not delta.is_empty else service.full_cluster)
        with service._lock:
            if op == "cluster_delta":
                # topology changed: warm states tied to the old one go
                # (a replica holds none; a restoring primary rebuilds
                # them on demand)
                service._states.clear()
                service._state_order.clear()
            service.cluster = new_cluster
            delta_id = entry.get("delta_id")
            if delta_id:
                service._applied_deltas[str(delta_id)] = dict(
                    entry.get("response") or {})
        fleet = entry.get("fleet")
        if fleet is not None:
            sched = service._ensure_sched()
            sched.restore_state(fleet)
            sched.cluster = service.cluster
    # ops carrying a notification re-materialize it in the notes window
    # with the ORIGINAL seq/ts, so a standby's /notifications stream is
    # byte-identical to the primary's
    note = entry.get("note")
    if note is not None:
        with service._note_cond:
            service._notes.append(dict(note))
            if len(service._notes) > service.NOTES_WINDOW:
                dropped = service._notes[:-service.NOTES_WINDOW]
                service._notes_dropped_high = max(
                    service._notes_dropped_high,
                    max(n["seq"] for n in dropped))
                del service._notes[:-service.NOTES_WINDOW]
            service._note_cond.notify_all()
