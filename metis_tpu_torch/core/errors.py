"""Framework exception hierarchy.

The port's copy of ``metis_tpu/core/errors.py``.

The reference signals "this plan can't be costed" with a bare ``KeyError``
caught per-plan (``cost_het_cluster.py:46-47``); we keep that contract but give
it a name so callers can distinguish missing-profile pruning from real bugs.
"""
from __future__ import annotations


class MetisError(Exception):
    """Base class for all framework errors."""


class ProfileMissError(MetisError, KeyError):
    """A (device_type, tp, bs) combination is absent from the profile store.

    Subclasses KeyError so strict-compat call sites behave exactly like the
    reference's per-plan KeyError pruning.
    """

    def __init__(self, device_type: str, tp: int, bs: int):
        super().__init__(f"no profile for device_type={device_type} tp={tp} bs={bs}")
        self.device_type = device_type
        self.tp = tp
        self.bs = bs


class InfeasiblePlanError(MetisError):
    """No memory-feasible layer partition exists for a candidate."""


class KvCacheOomError(MetisError):
    """A serving placement's weights already exhaust the stage's HBM — there
    is no headroom for even one sequence of KV cache.  Raised instead of
    returning a max batch of 0 so callers can't mistake "this placement can
    never serve" for "serve with batch 0" (``balance/stage_perf.py``)."""

    def __init__(self, stage: int, weights_mb: float, capacity_mb: float):
        super().__init__(
            f"stage {stage}: weights {weights_mb:.1f} MB >= HBM capacity "
            f"{capacity_mb:.1f} MB — no KV-cache headroom")
        self.stage = stage
        self.weights_mb = weights_mb
        self.capacity_mb = capacity_mb


class ClusterSpecError(MetisError):
    """Malformed cluster description."""


class CheckpointCorruptError(MetisError):
    """A checkpoint on disk failed integrity verification — a truncated or
    garbage array file, a digest mismatch against ``CheckpointMeta.digests``,
    or an unreadable orbax store.  Restore paths raise this (never a raw
    deserialization traceback) so callers can fall back to the retained
    ``.prev`` checkpoint (``execution/checkpoint.py``)."""


class CheckpointWriteError(MetisError, OSError):
    """An (async) checkpoint write failed.  Subclasses OSError so the
    default ``RetryPolicy`` transient classification retries it; the message
    always carries the checkpoint path."""


class RetryExhaustedError(MetisError):
    """A retried operation failed on every allowed attempt
    (``resilience/retry.py``); ``__cause__`` is the final attempt's error."""

    def __init__(self, op: str, attempts: int, last_error: BaseException):
        super().__init__(
            f"{op} failed after {attempts} attempt(s): "
            f"{type(last_error).__name__}: {last_error}")
        self.op = op
        self.attempts = attempts


class DeviceLossError(MetisError):
    """A device/slice dropped out of the topology mid-run.  ``lost`` maps
    device type -> device count; the training supervisor answers it with
    checkpoint -> replan-on-survivors -> restore
    (``resilience/supervisor.py``)."""

    def __init__(self, lost: dict[str, int], step: int | None = None):
        desc = ", ".join(f"{n}x{t}" for t, n in lost.items()) or "unknown"
        super().__init__(f"device loss at step {step}: {desc}")
        self.lost = dict(lost)
        self.step = step


class TenantSpecError(MetisError):
    """Malformed or unschedulable tenant description — an empty name, a
    negative quota, a ceiling below the floor, or a zero-quota tenant
    (``quota_ceiling=0``) that could never hold a single device.  Raised at
    registration/admission time so a broken tenant never reaches the fleet
    partitioner (``sched/tenant.py``)."""


class FleetOverCommitError(MetisError):
    """The fleet cannot honor every registered tenant's quota floor — the
    floors sum past the surviving capacity (or node granularity makes them
    unsatisfiable).  Raised by admission control and by shrink-time
    preemption instead of silently starving a tenant below its guarantee
    (``sched/fleet.py``)."""

    def __init__(self, msg: str, *, required: int | None = None,
                 available: int | None = None):
        super().__init__(msg)
        self.required = required
        self.available = available


class MigrationError(MetisError):
    """A live plan migration cannot proceed or failed verification — an
    incompatible src/dst state structure, a post-transfer digest mismatch,
    or an injected ``reshard_verify`` fault.  The supervisor answers it by
    degrading to the checkpoint-restore path (``migration_fallback``
    event); state is never lost (``execution/reshard.py``)."""


class TrainingAnomalyError(MetisError):
    """A loss anomaly (NaN/inf or spike) with no checkpoint to roll back
    to, or with rollback disabled — training cannot safely continue."""


class SnapshotCorruptError(MetisError):
    """A serve-daemon state snapshot failed integrity verification — a
    truncated or garbage JSON file, or a sha256 digest mismatch against
    the digest recorded at write.  The restore path raises this (never a
    raw deserialization traceback) so boot can fall back to the retained
    ``.prev`` generation (``serve/persist.py``)."""


class StandbyReadOnlyError(MetisError):
    """A state-mutating request reached a standby daemon.  A standby
    replicates the primary's oplog and answers read-only queries; writes
    must go to the primary (or wait for promotion).  The HTTP layer maps
    this to 503 with ``"standby": true`` so a failover-aware client can
    advance to the next address (``serve/standby.py``)."""
