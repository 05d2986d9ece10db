"""Deterministic, seedable fault injection — the port of
``metis_tpu/resilience/faults.py``, copied (it is plain Python).  In this
slice the live reshard (``execution/reshard.py``) consults
``reshard_send`` and ``reshard_verify``; the other points are consulted by
the training supervisor, which comes with ROADMAP §A.5.

Real clusters lose slices, corrupt writes, and preempt jobs; this module
makes every one of those failure modes drillable in CI on CPU.  The rest of
the stack consults a :class:`FaultInjector` at **named injection points**
and reacts exactly as it would to the real fault:

==================  =======================================================
point               what the consulting site does when it fires
==================  =======================================================
``checkpoint_write``  raise an ``OSError`` from the checkpoint write path
                      (drills the ``RetryPolicy`` + crash-safe swap)
``device_loss``       treat ``spec.lost_devices()`` as gone: checkpoint ->
                      replan on the survivor topology -> restore
``loss_nan``          the observed step loss becomes NaN (drills the
                      anomaly guard's rollback)
``loss_spike``        the observed step loss is multiplied far past the
                      spike band (drills the spike detector)
``preempt``           simulated SIGTERM: drain the in-flight step, final
                      checkpoint, clean exit
``spot_preemption``   spot-tier eviction: ``spec.lost_devices()`` vanish ->
                      shrink -> replan on survivors -> restore (emits a
                      ``preemption`` event first)
``spot_return``       evicted spot capacity comes back: grow toward the
                      full topology -> replan (emits ``spot_return``)
``reshard_send``      raise an ``OSError`` from a live-migration leaf
                      transfer (drills retry, then checkpoint-restore
                      fallback via ``migration_fallback``)
``reshard_verify``    the post-transfer digest check reports a mismatch
                      (drills the corruption guard on the migration path)
==================  =======================================================

Scripts are fully deterministic: each entry names a point, the step it
arms at, and how many consults it fires for.  An optional per-entry
probability is resolved by a **seeded** RNG, so even "random" chaos replays
identically for a given seed.  Every firing emits a ``fault_injected``
event (``core/events.py``).

Script syntax (the reference's ``--fault-script``)::

    point[@step][xTIMES][:arg][~prob] , ...

    checkpoint_write@2x2          # fail the ckpt write twice from step 2
    device_loss@5:A100=4          # lose 4 A100 devices at step 5
    loss_nan@3                    # step-3 loss comes back NaN
    preempt@7                     # SIGTERM-equivalent at step 7
    checkpoint_write~0.5          # each write fails with p=0.5 (seeded)
"""
from __future__ import annotations

import random
import re
from dataclasses import dataclass, field

from metis_tpu_torch.core.events import NULL_LOG, EventLog

INJECTION_POINTS = (
    "checkpoint_write",
    "device_loss",
    "loss_nan",
    "loss_spike",
    "preempt",
    "spot_preemption",
    "spot_return",
    "reshard_send",
    "reshard_verify",
)

#: Points whose arg is a ``TYPE=COUNT[,...]`` device map (lost_devices()).
_DEVICE_MAP_POINTS = ("device_loss", "spot_preemption", "spot_return")

_ENTRY_RE = re.compile(
    r"^(?P<point>[a-z_]+)"
    r"(?:@(?P<step>\d+))?"
    r"(?:x(?P<times>\d+))?"
    r"(?::(?P<arg>[^~]+))?"
    r"(?:~(?P<prob>[0-9.]+))?$")


@dataclass(frozen=True)
class FaultSpec:
    """One scripted fault: fire at ``point`` for the first ``times``
    consults whose step is >= ``step`` (None = the very first consult)."""

    point: str
    step: int | None = None
    times: int = 1
    arg: str | None = None
    prob: float = 1.0

    def __post_init__(self) -> None:
        if self.point not in INJECTION_POINTS:
            raise ValueError(
                f"unknown injection point {self.point!r} "
                f"(known: {', '.join(INJECTION_POINTS)})")
        if self.times < 1:
            raise ValueError("times must be >= 1")
        if not 0.0 < self.prob <= 1.0:
            raise ValueError("prob must be in (0, 1]")

    def lost_devices(self) -> dict[str, int]:
        """Parse a device-map arg (``device_loss``/``spot_preemption``/
        ``spot_return``) like ``A100=4`` or ``A100=4,T4=2`` into a type ->
        count map (empty = "supervisor picks a default")."""
        if not self.arg:
            return {}
        out: dict[str, int] = {}
        for part in self.arg.split(","):
            t, _, n = part.partition("=")
            if not t or not n.isdigit() or int(n) < 1:
                raise ValueError(
                    f"bad {self.point} arg {self.arg!r} (want TYPE=COUNT[,..])")
            out[t] = out.get(t, 0) + int(n)
        return out


def parse_fault_script(text: str) -> tuple[FaultSpec, ...]:
    """Parse the compact comma-separated script syntax (module docstring)."""
    specs: list[FaultSpec] = []
    for raw in text.split(","):
        raw = raw.strip()
        if not raw:
            continue
        # device-map args may themselves contain commas (A100=4,T4=2): glue
        # a TYPE=COUNT fragment onto the previous device-mapped entry
        if specs and re.fullmatch(r"[\w-]+=\d+", raw) \
                and specs[-1].point in _DEVICE_MAP_POINTS:
            prev = specs.pop()
            arg = f"{prev.arg},{raw}" if prev.arg else raw
            specs.append(FaultSpec(prev.point, prev.step, prev.times, arg,
                                   prev.prob))
            continue
        m = _ENTRY_RE.match(raw)
        if not m:
            raise ValueError(f"bad fault-script entry {raw!r}")
        specs.append(FaultSpec(
            point=m.group("point"),
            step=int(m.group("step")) if m.group("step") else None,
            times=int(m.group("times")) if m.group("times") else 1,
            arg=m.group("arg"),
            prob=float(m.group("prob")) if m.group("prob") else 1.0,
        ))
    return tuple(specs)


@dataclass
class _Armed:
    spec: FaultSpec
    remaining: int = field(default=0)


class FaultInjector:
    """Consultable fault script.  ``check(point, step)`` returns the
    :class:`FaultSpec` to realize (decrementing its budget and emitting a
    ``fault_injected`` event) or None.  A never-armed injector is a cheap
    no-op, so production call sites consult unconditionally."""

    def __init__(self, script: tuple[FaultSpec, ...] | str = (),
                 seed: int = 0, events: EventLog = NULL_LOG):
        if isinstance(script, str):
            script = parse_fault_script(script)
        self._armed = [_Armed(s, s.times) for s in script]
        self._rng = random.Random(seed)
        self.events = events
        self.fired: list[dict] = []

    @property
    def armed(self) -> bool:
        return any(a.remaining > 0 for a in self._armed)

    def check(self, point: str, step: int | None = None) -> FaultSpec | None:
        if point not in INJECTION_POINTS:
            raise ValueError(f"unknown injection point {point!r}")
        for a in self._armed:
            if a.remaining <= 0 or a.spec.point != point:
                continue
            if (a.spec.step is not None and step is not None
                    and step < a.spec.step):
                continue
            if a.spec.prob < 1.0 and self._rng.random() >= a.spec.prob:
                continue
            a.remaining -= 1
            rec = {"point": point, "step": step,
                   "times_left": a.remaining, "arg": a.spec.arg}
            self.fired.append(rec)
            self.events.emit("fault_injected", **rec)
            return a.spec
        return None


#: Shared no-op injector — the "nothing is scripted" default.
NULL_INJECTOR = FaultInjector()
