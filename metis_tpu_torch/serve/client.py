"""Thin stdlib client for the plan daemon — the port of
``metis_tpu/serve/client.py``; it speaks to either package's daemon.

Speaks the ``serve/daemon.py`` JSON-over-HTTP protocol against either a
TCP address (``http://127.0.0.1:8642`` or bare ``127.0.0.1:8642``) or a
unix socket (``unix:/run/metis-plan.sock``).

Connections are POOLED per address: a request checks an idle keep-alive
socket out of the pool, runs one round-trip, and checks it back in when
the daemon left it open — the per-request TCP handshake the old
one-connection-per-request client paid on every call is gone, which is
most of the cached-hit latency at high qps.  Thread-safe: the pool is a
lock-guarded free list, a connection is owned by exactly one thread
between checkout and checkin, and any number of threads can hold
distinct connections concurrently (the ≥64-thread concurrency contract
of the reference's ``tools/serve_smoke.py``).  A pooled socket the daemon idle-closed
between requests surfaces as an EOF on reuse; every endpoint is
idempotent, so the request transparently retries once on a fresh
connection.  Long-poll and streaming GETs (``notifications``,
``metrics``, ``healthz`` — anything holding the socket for seconds) use
dedicated non-pooled sockets so monitoring can never starve the
plan-query pool.

Every request mints a ``trace_id`` (or forwards the caller's) — POSTs in
the JSON body, GETs as a ``trace_id`` query parameter — so the daemon can
stamp every span, event, and background thread the request triggers: the
handle ``metis-tpu report --trace ID`` reconstructs one request's story
from.  The response echoes it back as ``trace_id``.

Failover: the constructor accepts a LIST of addresses (primary first,
standbys after).  Because every endpoint is idempotent — plan answers are
deterministic + cached, and ``/cluster_delta`` carries a client-minted
``delta_id`` the daemon deduplicates — a request that finds its address
dead (or answering the standby 503) simply moves to the next address in
the list and retries; the address that answers becomes the preferred one
for subsequent requests.
"""
from __future__ import annotations

import dataclasses
import http.client
import json
import socket
import threading
import time
import uuid
from typing import Any, Sequence

from metis_tpu_torch.core.config import ModelSpec, SearchConfig
from metis_tpu_torch.core.errors import MetisError


class ServeClientError(MetisError):
    """Daemon unreachable, or it answered with an error status."""


class _StandbyAnswer(Exception):
    """Internal: the address answered 503 + ``"standby": true`` — not an
    error, a redirect-to-the-next-address signal for the failover loop."""


def mint_trace_id() -> str:
    """A fresh 16-hex-char request id (collision odds are irrelevant at
    daemon-lifetime event volumes; short enough to read in a log line)."""
    return uuid.uuid4().hex[:16]


class _UnixHTTPConnection(http.client.HTTPConnection):
    def __init__(self, path: str, timeout: float):
        super().__init__("localhost", timeout=timeout)
        self._socket_path = path

    def connect(self) -> None:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        sock.connect(self._socket_path)
        self.sock = sock


def _parse_address(address: str) -> tuple:
    """``("unix", path)`` or ``("tcp", host, port)``; raises the same
    typed error for malformed addresses the single-address client did."""
    if address.startswith("unix:"):
        return ("unix", address[len("unix:"):])
    hostport = address
    if hostport.startswith("http://"):
        hostport = hostport[len("http://"):]
    hostport = hostport.rstrip("/")
    host, _, port = hostport.rpartition(":")
    if not host or not port.isdigit():
        raise ServeClientError(
            f"bad daemon address {address!r} — expected "
            "http://HOST:PORT or unix:/path/to.sock")
    return ("tcp", host, int(port))


class PlanServiceClient:
    """Client for one daemon address — or an address LIST (primary first,
    standbys after) for transparent failover; every method is one
    round-trip against the currently-preferred address."""

    # idle keep-alive connections retained per address; checkouts beyond
    # this just open fresh sockets, so the cap bounds idle FDs, not
    # concurrency
    MAX_IDLE = 16

    def __init__(self, address: str | Sequence[str], timeout: float = 300.0,
                 pool_connections: bool = True):
        addresses = ([address] if isinstance(address, str)
                     else [str(a) for a in address])
        if not addresses:
            raise ServeClientError("need at least one daemon address")
        self.addresses = list(addresses)
        # back-compat: .address stays the constructor's (first) address;
        # .active_address is the one currently answering
        self.address = self.addresses[0]
        self.timeout = timeout
        self.pool_connections = pool_connections
        self._endpoints = [_parse_address(a) for a in self.addresses]
        self._active = 0
        self._pool_lock = threading.Lock()
        self._idle: list[list[http.client.HTTPConnection]] = [
            [] for _ in self.addresses]
        self._reused = 0
        self._opened = 0

    def pool_stats(self) -> dict:
        """Connection-pool accounting: sockets opened, requests served on
        a reused keep-alive socket, idle sockets currently pooled."""
        with self._pool_lock:
            return {"opened": self._opened, "reused": self._reused,
                    "idle": sum(len(p) for p in self._idle)}

    def close(self) -> None:
        """Drop every pooled idle connection.  Safe to keep using the
        client afterwards — requests just open fresh sockets."""
        with self._pool_lock:
            doomed = [c for p in self._idle for c in p]
            for p in self._idle:
                p.clear()
        for c in doomed:
            c.close()

    def __enter__(self) -> "PlanServiceClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def active_address(self) -> str:
        """The address the last successful request used (the failover
        loop's current preference)."""
        return self.addresses[self._active]

    def _connection(self, endpoint: tuple,
                    timeout: float | None = None
                    ) -> http.client.HTTPConnection:
        t = timeout if timeout is not None else self.timeout
        if endpoint[0] == "unix":
            return _UnixHTTPConnection(endpoint[1], t)
        return http.client.HTTPConnection(endpoint[1], endpoint[2],
                                          timeout=t)

    def _acquire(self, ix: int,
                 timeout: float | None, dedicated: bool
                 ) -> tuple[http.client.HTTPConnection, bool]:
        """A connection for address ``ix``: ``(conn, reused)``.  Pooled
        unless the caller wants a dedicated socket or a per-call timeout
        (a pooled socket's timeout was fixed at creation)."""
        if dedicated or timeout is not None or not self.pool_connections:
            return self._connection(self._endpoints[ix],
                                    timeout=timeout), False
        with self._pool_lock:
            idle = self._idle[ix]
            if idle:
                self._reused += 1
                return idle.pop(), True
            self._opened += 1
        return self._connection(self._endpoints[ix]), False

    def _release(self, ix: int, conn: http.client.HTTPConnection) -> None:
        """Return a fully-drained keep-alive connection to the pool (or
        close it past the idle cap)."""
        with self._pool_lock:
            idle = self._idle[ix]
            if len(idle) < self.MAX_IDLE:
                idle.append(conn)
                return
        conn.close()

    def _drop_idle(self, ix: int) -> None:
        """Close every pooled connection to one address — it just failed,
        so its idle sockets are presumed dead too."""
        with self._pool_lock:
            doomed = self._idle[ix]
            self._idle[ix] = []
        for c in doomed:
            c.close()

    def _request(self, method: str, path: str,
                 payload: dict | None = None,
                 timeout: float | None = None, raw: bool = False,
                 error_ok: bool = False, dedicated: bool = False) -> Any:
        """One logical round-trip with failover: each configured address
        is tried in order starting from the active one; an unreachable
        address or a standby's read-only 503 advances to the next.  The
        retry across addresses is safe for the same reason the in-address
        connect retry is — every endpoint is idempotent."""
        last_err: ServeClientError | None = None
        n = len(self._endpoints)
        for attempt in range(n):
            ix = (self._active + attempt) % n
            try:
                out = self._request_one(ix, method, path, payload,
                                        timeout=timeout, raw=raw,
                                        error_ok=error_ok,
                                        dedicated=dedicated)
            except _StandbyAnswer:
                last_err = ServeClientError(
                    f"plan daemon at {self.addresses[ix]} is a read-only "
                    "standby")
                continue
            except ServeClientError as e:
                self._drop_idle(ix)
                last_err = e
                continue
            self._active = ix
            return out
        assert last_err is not None
        raise last_err

    def _request_one(self, ix: int, method: str, path: str,
                     payload: dict | None = None, _retries: int = 3,
                     timeout: float | None = None, raw: bool = False,
                     error_ok: bool = False, dedicated: bool = False) -> Any:
        """One round-trip against one address.  ``timeout`` overrides the
        client default for this call (the monitoring GETs want seconds,
        not the 300 s plan budget).  ``raw=True`` returns the decoded body
        text instead of parsed JSON (/metrics is text exposition, not
        JSON).  ``error_ok=True`` returns error-status bodies instead of
        raising (/healthz answers 503 by design when not ready).
        ``dedicated=True`` bypasses the connection pool — long-poll and
        streaming GETs hold the socket for seconds and must never park a
        plan-query connection behind them."""
        address = self.addresses[ix]
        conn, reused = self._acquire(ix, timeout, dedicated)
        body = json.dumps(payload).encode() if payload is not None \
            else None
        headers = {"Content-Type": "application/json"} if body else {}
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            status = resp.status
        except ConnectionError as e:
            conn.close()
            if reused:
                # a pooled socket the daemon idle-closed between requests:
                # EOF on reuse is expected, not a failure — retry once on
                # a fresh connection without burning the connect budget
                # (safe: every endpoint is idempotent)
                return self._request_one(ix, method, path, payload,
                                         _retries=_retries,
                                         timeout=timeout, raw=raw,
                                         error_ok=error_ok,
                                         dedicated=dedicated)
            # a connect burst can still outrun the daemon's accept
            # backlog; every endpoint is idempotent (plan answers are
            # deterministic + cached), so a short retry is safe
            if _retries > 0:
                time.sleep(0.05)
                return self._request_one(ix, method, path, payload,
                                         _retries=_retries - 1,
                                         timeout=timeout, raw=raw,
                                         error_ok=error_ok,
                                         dedicated=dedicated)
            raise ServeClientError(
                f"plan daemon at {address} unreachable: {e}") \
                from e
        except (OSError, http.client.HTTPException) as e:
            conn.close()
            raise ServeClientError(
                f"plan daemon at {address} unreachable: {e}") \
                from e
        # the response is fully drained: pool the socket when the daemon
        # left it open (even on an error status — a 4xx/standby 503 is a
        # healthy connection), close it otherwise
        if (not dedicated and timeout is None and self.pool_connections
                and not resp.will_close and conn.sock is not None):
            self._release(ix, conn)
        else:
            conn.close()
        if raw:
            if status >= 400 and not error_ok:
                raise ServeClientError(
                    f"daemon error {status}: {data!r}")
            return data.decode("utf-8", errors="replace")
        try:
            out = json.loads(data) if data else {}
        except json.JSONDecodeError as e:
            raise ServeClientError(
                f"daemon sent invalid JSON ({e.msg})") from e
        if status >= 400 and not error_ok:
            if status == 503 and isinstance(out, dict) \
                    and out.get("standby"):
                # a mutation hit a standby: not this request's fault —
                # signal the failover loop to try the next address
                raise _StandbyAnswer()
            detail = out.get("error") if isinstance(out, dict) else None
            raise ServeClientError(
                f"daemon error {status}: {detail or data!r}")
        return out

    # -- endpoints ----------------------------------------------------------
    def plan(self, model: ModelSpec, config: SearchConfig,
             top_k: int | None = None, workload=None,
             trace_id: str | None = None) -> dict:
        """Plan query; the response's ``plans`` field is the exact
        ``dump_ranked_plans`` (training) or ``dump_inference_plans``
        (``workload`` set) JSON string the offline CLI prints."""
        payload = {
            "model": dataclasses.asdict(model),
            "config": dataclasses.asdict(config),
            "top_k": top_k,
            "trace_id": trace_id or mint_trace_id(),
        }
        if workload is not None:
            payload["workload"] = (workload if isinstance(workload, dict)
                                   else dataclasses.asdict(workload))
        return self._request("POST", "/plan", payload)

    def tenant_plan(self, name: str,
                    trace_id: str | None = None) -> dict:
        """Tenant-routed plan query: the daemon answers from the fleet
        scheduler's current carve for ``name`` (model/config/workload come
        from the registered TenantSpec, not this call)."""
        return self._request("POST", "/plan", {
            "tenant": name, "trace_id": trace_id or mint_trace_id()})

    def tenant_register(self, spec) -> dict:
        """Register a tenant (a ``sched.TenantSpec`` or its dict form)."""
        payload = spec if isinstance(spec, dict) else dataclasses.asdict(spec)
        return self._request("POST", "/tenant", payload)

    def tenant_remove(self, name: str) -> dict:
        return self._request("POST", "/tenant_remove", {"name": name})

    def tenant_status(self, name: str | None = None,
                      trace_id: str | None = None) -> dict:
        tid = trace_id or mint_trace_id()
        path = (f"/tenant?trace_id={tid}" if name is None
                else f"/tenant?name={name}&trace_id={tid}")
        return self._request("GET", path)

    def accuracy_sample(self, fingerprint: str, measured_ms: float,
                        step: int | None = None, stage_ms=(),
                        predicted_ms: float | None = None,
                        trace_id: str | None = None) -> dict:
        payload: dict[str, Any] = {
            "fingerprint": fingerprint, "measured_ms": measured_ms,
            "step": step, "stage_ms": list(stage_ms),
            "trace_id": trace_id or mint_trace_id(),
        }
        if predicted_ms is not None:
            payload["predicted_ms"] = predicted_ms
        return self._request("POST", "/accuracy_sample", payload)

    def cluster_delta(self, removed: dict[str, int] | None = None,
                      added: dict[str, int] | None = None,
                      replan: bool = False,
                      trace_id: str | None = None,
                      cause: str | None = None,
                      delta_id: str | None = None) -> dict:
        """``cause`` labels the delta's trigger in the decision log
        ("preemption", "spot_return", "autoscale", ...) so every replan
        it fans out to chains back to the real-world event.

        Deltas are RELATIVE, so this is the one endpoint a blind retry
        could corrupt: a ``delta_id`` (minted here when not supplied) is
        sent with the request and the daemon answers a duplicate id from
        its dedup window instead of applying the delta twice."""
        payload: dict[str, Any] = {
            "removed": removed or {}, "added": added or {},
            "replan": replan, "trace_id": trace_id or mint_trace_id(),
            "delta_id": delta_id or mint_trace_id()}
        if cause:
            payload["cause"] = cause
        return self._request("POST", "/cluster_delta", payload)

    def invalidate(self, fingerprint: str | None = None,
                   drop_states: bool = False) -> dict:
        return self._request("POST", "/invalidate", {
            "fingerprint": fingerprint, "drop_states": drop_states})

    def notifications(self, since: int = 0, timeout_s: float = 0.0,
                      trace_id: str | None = None) -> list[dict]:
        return self.notifications_window(
            since=since, timeout_s=timeout_s,
            trace_id=trace_id).get("notifications", [])

    def notifications_window(self, since: int = 0, timeout_s: float = 0.0,
                             trace_id: str | None = None) -> dict:
        """The full ``/notifications`` document: ``notifications`` plus
        the gap-detection metadata — ``truncated`` means notes past
        ``since`` already fell off the daemon's bounded backlog and the
        caller must resync (re-query, or replay ``oplog(since=...)``)
        instead of trusting the list to be complete."""
        tid = trace_id or mint_trace_id()
        return self._request(
            "GET", f"/notifications?since={since}&timeout={timeout_s}"
                   f"&trace_id={tid}", dedicated=True)

    def oplog(self, since: int = 0, trace_id: str | None = None) -> dict:
        """State-mutation oplog entries with ``seq > since`` from
        ``GET /oplog`` — the replication feed a standby tails.  The
        document carries ``entries``, ``last_seq``, ``oldest_seq`` and
        ``truncated`` (True when the requested range predates what the
        daemon still holds, so the tailer must bootstrap from a snapshot
        instead)."""
        tid = trace_id or mint_trace_id()
        return self._request(
            "GET", f"/oplog?since={since}&trace_id={tid}")

    def decisions(self, since: int = 0,
                  trace_id: str | None = None) -> list[dict]:
        """Decision records with ``seq > since`` from ``GET /decisions``
        — the durable provenance feed (``obs/provenance.DecisionLog``).
        Each entry is a ``DecisionRecord.to_json_dict()``."""
        tid = trace_id or mint_trace_id()
        out = self._request(
            "GET", f"/decisions?since={since}&trace_id={tid}")
        return out.get("decisions", [])

    def stats(self) -> dict:
        return self._request("GET", "/stats")

    def metrics(self, timeout: float | None = None) -> str:
        """Raw Prometheus text exposition from ``GET /metrics``.  Pass a
        short ``timeout`` when scraping on a schedule — the endpoint
        never searches, so a slow answer means a sick daemon.  Scrapes run
        on a dedicated socket so a slow scraper can't park a plan-query
        connection."""
        return self._request("GET", "/metrics", timeout=timeout, raw=True,
                             dedicated=True)

    def healthz(self, timeout: float | None = None) -> dict:
        """Liveness/readiness from ``GET /healthz``.  Returns the health
        document even on 503 (not-ready IS the answer, not an error);
        raises only when the daemon is unreachable.  Probes run on a
        dedicated socket, same rationale as :meth:`metrics`."""
        return self._request("GET", "/healthz", timeout=timeout,
                             error_ok=True, dedicated=True)

    def shutdown(self) -> dict:
        return self._request("POST", "/shutdown", {})
