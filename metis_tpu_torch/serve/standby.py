"""Oplog-replicated standby for the plan daemon — the port of
``metis_tpu/serve/standby.py``.

A standby is a full :class:`~metis_tpu_torch.serve.daemon.PlanService` booted
with ``read_only=True`` (same profiles, same boot topology as the
primary) whose state is driven exclusively by the primary's oplog:
:class:`StandbyTailer` polls ``GET /oplog?since=N`` and applies every
entry through :func:`metis_tpu_torch.serve.persist.apply_entry` — the exact
code path a restarting primary replays its own log through, so a
promoted standby is byte-identical to a restored primary by
construction.

While tailing, the standby answers read traffic (replicated cache hits,
tenant status, stats, notifications — its ``/notifications`` stream
carries the primary's original seq numbers) and rejects mutations with
503 + ``"standby": true``, which a failover-aware
:class:`~metis_tpu_torch.serve.client.PlanServiceClient` treats as
"try the next address".  When ``promote_after`` consecutive polls fail
to reach the primary, the tailer promotes its service in place: the
read-only latch drops, a ``failover`` event + note record the takeover
and the last replicated seq, and the op-seq continues from where the
primary's log stopped — zero tenant plans lost
(``tests/test_torch_ha.py``).
"""
from __future__ import annotations

import threading

from metis_tpu_torch.serve import persist
from metis_tpu_torch.serve.client import PlanServiceClient, ServeClientError


class StandbyTailer:
    """Drives one read-only PlanService from a primary's oplog feed.

    ``primary`` is an address (``http://host:port`` / ``unix:...``) or a
    ready :class:`PlanServiceClient`.  ``poll_interval_s`` is the idle
    delay between polls; ``promote_after`` consecutive unreachable polls
    trigger promotion (with the default 0.25 s interval and a short
    client timeout, failover lands well under the drill's 1 s budget).
    """

    def __init__(self, service, primary,
                 poll_interval_s: float = 0.25,
                 promote_after: int = 3,
                 client_timeout_s: float = 5.0):
        if not service.read_only:
            raise ValueError(
                "standby service must be built with read_only=True — a "
                "writable service would mint op seqs the primary's oplog "
                "never saw")
        self.service = service
        self.client = (primary if isinstance(primary, PlanServiceClient)
                       else PlanServiceClient(primary,
                                              timeout=client_timeout_s))
        self.poll_interval_s = poll_interval_s
        self.promote_after = promote_after
        self.promoted = False
        self.failures = 0
        self.last_primary_seq: int | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- replication --------------------------------------------------------
    def sync_once(self) -> int:
        """One poll: fetch entries past the local cursor and apply them;
        returns the number applied.  Raises
        :class:`~metis_tpu_torch.serve.client.ServeClientError` when the
        primary is unreachable (the caller's promotion signal)."""
        svc = self.service
        out = self.client.oplog(since=svc._note_seq)
        if out.get("truncated"):
            # only possible against a primary serving from its bounded
            # in-memory tail (no --state-dir): the gap cannot be replayed,
            # so refusing loudly beats silently diverging
            raise ServeClientError(
                f"primary oplog truncated below seq {svc._note_seq}: "
                "standby cannot catch up (run the primary with "
                "--state-dir for a full-history oplog)")
        applied = 0
        svc._replaying = True
        try:
            for entry in out.get("entries", []):
                persist.apply_entry(svc, entry)
                applied += 1
        finally:
            svc._replaying = False
        self.last_primary_seq = int(out.get("last_seq") or svc._note_seq)
        svc.metrics.gauge("metis_standby_oplog_lag").set(
            max(0, self.last_primary_seq - svc._note_seq))
        return applied

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.sync_once()
                self.failures = 0
            except ServeClientError:
                self.failures += 1
                if self.failures >= self.promote_after:
                    self.promote(reason="primary_unreachable")
                    return
            self._stop.wait(self.poll_interval_s)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="metis-standby-tail", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def promote(self, reason: str = "operator") -> dict:
        """Take over as primary: drop the read-only latch, record the
        ``failover`` event + note, and (when the service has a state
        dir) write an immediate snapshot and start the periodic
        snapshotter — from here on it IS a primary, appending fresh ops
        after the last replicated seq."""
        svc = self.service
        with svc._note_cond:
            last_seq = svc._note_seq
        svc.read_only = False
        self.promoted = True
        self._stop.set()
        svc.metrics.gauge("metis_standby_oplog_lag").set(0)
        svc.counters.inc("serve.failovers")
        svc.events.emit("failover", last_seq=last_seq, reason=reason)
        svc._push_note({"kind": "failover", "reason": reason,
                        "last_seq": last_seq})
        if svc._snapshot_store is not None:
            svc.snapshot_now()
            if svc._snap_thread is None and svc.snapshot_interval > 0:
                svc._snap_thread = threading.Thread(
                    target=svc._snapshot_loop,
                    name="metis-serve-snapshot", daemon=True)
                svc._snap_thread.start()
        return {"last_seq": last_seq, "reason": reason}
