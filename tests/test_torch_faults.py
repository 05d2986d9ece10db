"""The port's fault injector and retry policy
(``metis_tpu_torch/resilience/``) against the JAX package's: every form
of the fault script parses to the reference's ``FaultSpec``s, an injector
fires the same specs at the same consults for a seed, and ``RetryPolicy``
sleeps the reference's delays over the same attempts and ends the same
way."""
import dataclasses
import random

import pytest

from metis_tpu.core import errors as jerrors
from metis_tpu.resilience import faults as jfaults
from metis_tpu.resilience import retry as jretry
from metis_tpu_torch.core import errors as terrors
from metis_tpu_torch.resilience import faults as tfaults
from metis_tpu_torch.resilience import retry as tretry

SCRIPTS = [
    "checkpoint_write@2x2",
    "device_loss@5:A100=4",
    "device_loss@5:A100=4,T4=2",
    "loss_nan@3",
    "loss_spike@2x3~0.25",
    "preempt@7",
    "checkpoint_write~0.5",
    "spot_preemption@4:T4=2, spot_return@8:T4=2,A100=1",
    "reshard_send@3x2, reshard_verify",
    " , reshard_send ,",
]
BAD_SCRIPTS = ["bogus@1", "checkpoint_write@x", "loss_nan~0", "preempt~1.5",
               "loss_nanx0", "device_loss@1:A100", "reshard_send~0.3x4"]


def _specs(pkg, text):
    return [dataclasses.asdict(s) for s in pkg.parse_fault_script(text)]


@pytest.mark.parametrize("text", SCRIPTS)
def test_fault_script_parses_to_the_reference_specs(text):
    want = _specs(jfaults, text)
    assert _specs(tfaults, text) == want
    lost = [s.lost_devices() for s in jfaults.parse_fault_script(text)]
    assert [s.lost_devices() for s in tfaults.parse_fault_script(text)] == lost


@pytest.mark.parametrize("text", BAD_SCRIPTS)
def test_bad_fault_script_raises_as_the_reference(text):
    def outcome(pkg):
        try:
            specs = pkg.parse_fault_script(text)
            return [s.lost_devices() for s in specs]
        except ValueError as e:
            return ("ValueError", str(e))

    assert outcome(tfaults) == outcome(jfaults)


class _Events:
    def __init__(self):
        self.seen = []

    def emit(self, event, **fields):
        self.seen.append((event, fields))


CONSULTS = [(p, s) for s in range(10) for p in
            ("checkpoint_write", "reshard_send", "reshard_verify", "loss_nan",
             "device_loss")]


@pytest.mark.parametrize("text,seed", [
    ("checkpoint_write@2x2, reshard_send@3x2, loss_nan@4", 0),
    ("checkpoint_write~0.5, reshard_sendx4~0.3, device_loss@6:A100=2", 7),
    ("reshard_verify, reshard_send@1x3~0.6", 123),
])
def test_injector_fires_the_same_specs_at_the_same_consults(text, seed):
    runs = {}
    for name, pkg in (("ref", jfaults), ("port", tfaults)):
        events = _Events()
        inj = pkg.FaultInjector(text, seed=seed, events=events)
        fired = [(p, s, None if (f := inj.check(p, s)) is None
                  else dataclasses.asdict(f)) for p, s in CONSULTS]
        runs[name] = (fired, inj.fired, events.seen, inj.armed)
    assert runs["port"] == runs["ref"]
    assert not tfaults.NULL_INJECTOR.armed
    with pytest.raises(ValueError):
        tfaults.FaultInjector().check("no_such_point")


POLICIES = [
    dict(),
    dict(max_attempts=5, base_delay_s=0.1, backoff=3.0, max_delay_s=0.5,
         jitter=0.5, seed=11),
    dict(max_attempts=4, jitter=0.0),
    dict(max_attempts=6, base_delay_s=0.2, deadline_s=0.5, seed=3),
]


@pytest.mark.parametrize("kw", POLICIES)
def test_retry_delays_equal_the_reference(kw):
    j, t = jretry.RetryPolicy(**kw), tretry.RetryPolicy(**kw)
    rj, rt = random.Random(j.seed), random.Random(t.seed)
    assert ([t.delay_s(a, rt) for a in range(1, 8)]
            == [j.delay_s(a, rj) for a in range(1, 8)])
    for exc in (OSError("x"), TimeoutError(), ValueError("bug"),
                terrors.CheckpointWriteError("w")):
        assert t.classify(exc) == j.classify(exc)


def _call(pkg, errors_mod, kw, fails, error):
    """Run ``RetryPolicy.call`` on a function failing ``fails`` times with
    ``error``: the result or the error, the sleeps, the events and the
    ``on_retry`` calls."""
    policy = pkg.RetryPolicy(**kw)
    sleeps, retried, events, n = [], [], _Events(), [0]

    def fn():
        n[0] += 1
        if n[0] <= fails:
            raise error(f"attempt {n[0]}")
        return n[0]

    try:
        out = policy.call(fn, op="op", events=events, sleep=sleeps.append,
                          on_retry=lambda a, e: retried.append((a, str(e))))
    except errors_mod.RetryExhaustedError as e:
        out = ("exhausted", e.op, e.attempts, str(e.__cause__))
    except ValueError as e:
        out = ("fatal", str(e))
    drop = {"elapsed_s"}  # wall time of the drill
    seen = [(ev, {k: v for k, v in f.items() if k not in drop})
            for ev, f in events.seen]
    return out, sleeps, seen, retried, n[0]


@pytest.mark.parametrize("fails,error", [(0, OSError), (2, OSError),
                                         (9, OSError), (9, TimeoutError),
                                         (1, ValueError)])
@pytest.mark.parametrize("kw", POLICIES[:3])
def test_retry_call_equals_the_reference(kw, fails, error):
    assert (_call(tretry, terrors, kw, fails, error)
            == _call(jretry, jerrors, kw, fails, error))


def test_retry_policy_rejects_what_the_reference_rejects():
    for kw in (dict(max_attempts=0), dict(base_delay_s=3.0, max_delay_s=2.0),
               dict(jitter=1.0), dict(deadline_s=0.0)):
        for pkg in (jretry, tretry):
            with pytest.raises(ValueError):
                pkg.RetryPolicy(**kw)
