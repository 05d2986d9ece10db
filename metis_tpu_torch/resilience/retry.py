"""Bounded retry with exponential backoff and deterministic jitter — the
port of ``metis_tpu/resilience/retry.py``, copied (plain Python).

One reusable :class:`RetryPolicy` for every transient-failure site in the
stack (checkpoint IO first; anything that can hiccup without being wrong).
Classification is per exception class: transient errors are retried up to
``max_attempts`` with exponentially growing, deterministically jittered
delays; fatal errors re-raise immediately (retrying a bug only hides it).

Every retried attempt emits a ``retry_attempt`` event and exhaustion emits
``retry_exhausted`` + raises :class:`~metis_tpu_torch.core.errors.RetryExhaustedError`
chaining the last error — so a flaky filesystem is visible in the event
stream long before it becomes an outage.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, TypeVar

from metis_tpu_torch.core.errors import RetryExhaustedError
from metis_tpu_torch.core.events import NULL_LOG, EventLog

T = TypeVar("T")


@dataclass(frozen=True)
class RetryPolicy:
    """Retry shape: attempt budget, backoff curve, and the transient/fatal
    split.  The jitter is drawn from a ``seed``-initialized RNG per
    :meth:`call`, so a replayed drill sleeps the identical schedule."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    backoff: float = 2.0
    max_delay_s: float = 2.0
    jitter: float = 0.25  # +/- fraction of the computed delay
    seed: int = 0
    # total-elapsed budget across ALL attempts and backoff sleeps; None =
    # attempt-capped only.  The attempt cap bounds how many times a flaky
    # op runs, the deadline bounds how long a caller can be stalled — a
    # recovery path needs both (waiting out 3 slow backoffs can cost more
    # than the checkpoint-restore it guards).
    deadline_s: float | None = None
    # OSError covers filesystem/network IO (and CheckpointWriteError, which
    # subclasses it); anything not listed transient is fatal by default —
    # an unknown error class is a bug until proven otherwise.
    transient: tuple[type, ...] = (OSError, TimeoutError, ConnectionError)
    fatal: tuple[type, ...] = ()

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_delay_s < 0 or self.max_delay_s < self.base_delay_s:
            raise ValueError("need 0 <= base_delay_s <= max_delay_s")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be > 0 (or None)")

    def classify(self, exc: BaseException) -> str:
        """"transient" (retry) or "fatal" (re-raise immediately).  ``fatal``
        wins on overlap so a subclass can be carved out of a transient
        base."""
        if isinstance(exc, self.fatal):
            return "fatal"
        if isinstance(exc, self.transient):
            return "transient"
        return "fatal"

    def delay_s(self, attempt: int, rng: random.Random) -> float:
        """Backoff delay before retry number ``attempt`` (1-based), with
        deterministic +/-``jitter`` drawn from ``rng``."""
        d = min(self.base_delay_s * self.backoff ** (attempt - 1),
                self.max_delay_s)
        return d * (1.0 + self.jitter * (2.0 * rng.random() - 1.0))

    def call(self, fn: Callable[[], T], *, op: str = "operation",
             events: EventLog = NULL_LOG,
             sleep: Callable[[float], None] = time.sleep,
             on_retry: Callable[[int, BaseException], None] | None = None,
             ) -> T:
        """Run ``fn`` under this policy.  ``on_retry(attempt, error)`` is
        called before each backoff sleep (supervisor bookkeeping); ``sleep``
        is injectable so tests run at full speed.

        Exhaustion is whichever budget runs out first: the attempt cap, or
        ``deadline_s`` of total elapsed time — a retry whose next backoff
        would land past the deadline is not attempted (the sleep would
        stall the caller past its budget for an attempt it may not get)."""
        rng = random.Random(self.seed)
        t0 = time.monotonic()
        last: BaseException | None = None
        attempts = 0
        for attempt in range(1, self.max_attempts + 1):
            attempts = attempt
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — classified below
                last = e
                if self.classify(e) == "fatal":
                    raise
                if attempt == self.max_attempts:
                    break
                delay = self.delay_s(attempt, rng)
                if self.deadline_s is not None and \
                        time.monotonic() - t0 + delay > self.deadline_s:
                    break
                events.emit("retry_attempt", op=op, attempt=attempt,
                            delay_s=round(delay, 4),
                            error=f"{type(e).__name__}: {e}")
                if on_retry is not None:
                    on_retry(attempt, e)
                sleep(delay)
        events.emit("retry_exhausted", op=op, attempts=attempts,
                    deadline_s=self.deadline_s,
                    elapsed_s=round(time.monotonic() - t0, 4),
                    error=f"{type(last).__name__}: {last}")
        raise RetryExhaustedError(op, attempts, last) from last
