"""Fault-tolerant training supervisor: the run loop that survives — the
port of ``metis_tpu/resilience/supervisor.py``.

The planner's elastic story (``planner/replan.py``) and the checkpointer's
crash-safe story (``execution/checkpoint.py``) only pay off if something
DRIVES them when a run goes wrong.  :class:`TrainingSupervisor` does —
it wraps the executable step loop with:

- **loss anomaly guards** (``execution.train.LossAnomalyDetector``): a
  NaN/inf loss rolls the run back to the latest digest-verified checkpoint
  (restored into the running state, in place); a spike is reported
  (``anomaly_detected``) and survived;
- **retrying checkpoints** (:class:`RetryingCheckpointWriter`): periodic
  saves through a bounded-backoff :class:`~metis_tpu_torch.resilience.retry.RetryPolicy`
  with ``.prev`` retention, so transient IO never kills a run and a corrupt
  latest generation never loses it;
- **graceful preemption drain**: on SIGTERM (or an injected ``preempt``
  fault) the in-flight step finishes, a final checkpoint lands, and the run
  exits cleanly (``preempt_drain``);
- **replan-on-device-loss**: an (injected) ``device_loss`` fault shrinks
  the cluster to the survivor topology (``shrink_cluster``), re-plans on it
  (``replan(..., search_old=False)``), rebuilds the executable, and
  restores the latest checkpoint onto the NEW plan (through the
  checkpoint's slice maps), then resumes mid-stream (``recovery_complete``);
- **elastic spot fleet**: a ``spot_preemption`` fault is the same
  shrink→replan→restore flow preceded by a ``preemption`` event; a
  ``spot_return`` fault grows the cluster back toward the retained full
  reference topology (``grow_cluster``) and re-plans on the larger fleet;
- **live plan migration**: every replan-driven plan switch first asks
  whether the running state can be RESHARDED in place
  (``execution/reshard.py``): eligible when ``ResilienceConfig.live_migration``
  is on, the old and new device sets intersect, the state schemas are
  shape-compatible, and the priced transfer beats the checkpoint-restore
  baseline.  A successful migration keeps the CURRENT step; any migration
  fault emits ``migration_fallback`` and degrades to the checkpoint-restore
  path, so a failed migration costs time, never state.

**One rank per device.**  The reference is one controller over every
device; the port runs one process per device (``execution.dist``), and
every rank of the process group runs this loop over the whole cluster
(``cluster.total_devices`` ranks; one device runs without a group).  Every
rank takes the same decisions from the same inputs: the plan search runs
on rank 0 and its artifact is broadcast; rank 0's step loss is broadcast
before the anomaly guard reads it; every rank's ``FaultInjector`` holds the
same script and seed and is consulted at the same points in the same
order; a SIGTERM sets the flag of the rank that got it, and the ranks
agree on the drain through one all-reduce of their flags at the top of
each step; each recovery's ``recover_s`` is rank 0's.  So every rank's
:class:`SupervisorReport` is the same.  The decision log (``decisions``)
is written by rank 0 alone: each recovery appends the reference's chain,
a ``cluster_delta`` root, the replan's ``delta_replan`` child and a
``migration_decision`` grandchild.  Events go to the log the caller
passes: rank 0's ``EventLog`` on rank 0 (its injector's too), ``NULL_LOG``
elsewhere.  After a shrink the new plan runs on the group's first ranks
(``build_executable`` gives the others None); a rank outside the plan skips
the step and takes part in every collective: the agreements, the
checkpoint barriers, a live reshard (as a sender) and a later
``spot_return`` that brings it back into the plan.  A failure the ranks
reach together (a search that fails on rank 0, recoveries exhausted, a
non-finite loss) ends every rank's run as ``failed``; a failure of one
rank alone (a corrupt file of its own) is raised, so the launch fails at
once instead of its peers waiting in the next collective.

**A rank that really dies is not survived.**  ``torch.distributed`` cannot
rebuild a world without an elastic launcher, so, as in the reference's
drills, device loss and spot eviction are injected
(``resilience/faults.py``): the "lost" ranks stay up and leave the plan.

Every decision is visible in the event stream; the whole loop is drillable
on the host through ``resilience/faults.py``.
"""
from __future__ import annotations

import gc
import pickle
import signal
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import torch
import torch.distributed as dist

from metis_tpu_torch.cluster.spec import ClusterSpec
from metis_tpu_torch.core.config import ModelSpec, ResilienceConfig, SearchConfig
from metis_tpu_torch.core.device import resolve_device
from metis_tpu_torch.core.errors import (
    InfeasiblePlanError,
    MetisError,
    MigrationError,
    TrainingAnomalyError,
)
from metis_tpu_torch.core.events import NULL_LOG, EventLog
from metis_tpu_torch.core.trace import Tracer
from metis_tpu_torch.cost.volume import TransformerVolume
from metis_tpu_torch.execution.builder import (
    build_executable,
    checkpoint_block_layout,
    exec_state_to_train_state,
    plan_route,
    resolve_schedule,
    train_state_to_exec_state,
)
from metis_tpu_torch.execution.checkpoint import (
    AsyncCheckpointWriter,
    _family,
    _world,
    load_meta,
    load_plan,
    restore_checkpoint,
    restore_hetero_checkpoint,
    save_hetero_checkpoint,
)
from metis_tpu_torch.execution.mesh import PlanArtifact
from metis_tpu_torch.execution.train import LossAnomalyDetector, StepTimer
from metis_tpu_torch.obs.ledger import fingerprint_ranked_plan
from metis_tpu_torch.planner.api import plan_hetero
from metis_tpu_torch.planner.replan import (
    ClusterDelta,
    grow_cluster,
    replan,
    shrink_cluster,
)
from metis_tpu_torch.profiles.store import ProfileStore
from metis_tpu_torch.resilience.faults import NULL_INJECTOR, FaultInjector
from metis_tpu_torch.resilience.retry import RetryPolicy


def migration_decision(old_layout, new_layout, volume: TransformerVolume,
                       bw_gbps: float,
                       recover_s: float) -> tuple[str, float | None]:
    """The migrate-vs-checkpoint-restore rule: ``("migrate", price_ms)``
    when both per-stage ``(tp, layer_start, layer_end)`` layouts are known
    and the priced live transfer
    (:func:`execution.reshard.price_migration_ms`) beats the
    checkpoint-restore charge (``recover_s``); ``("ckpt",
    price_ms_or_None)`` otherwise."""
    from metis_tpu_torch.execution.reshard import price_migration_ms

    if not old_layout or not new_layout:
        return "ckpt", None
    price_ms = price_migration_ms(tuple(old_layout), tuple(new_layout),
                                  volume, bw_gbps)
    if price_ms < recover_s * 1000.0:
        return "migrate", price_ms
    return "ckpt", price_ms


class RetryingCheckpointWriter:
    """An :class:`AsyncCheckpointWriter` whose saves go through a
    :class:`RetryPolicy` — each attempt enqueues the async write and waits
    it durable, so transient IO failures (including injected
    ``checkpoint_write`` faults) surface inside the retry wrapper instead
    of steps later.  ``keep_prev=True`` retains the displaced generation
    as the corruption-fallback rollback.  Every rank calls ``save``
    together; an injected fault fires on every rank at once (the same
    script), so the ranks retry together."""

    def __init__(self, policy: RetryPolicy, events: EventLog = NULL_LOG,
                 faults: FaultInjector = NULL_INJECTOR,
                 keep_prev: bool = True,
                 sleep: Callable[[float], None] = time.sleep,
                 on_retry: Callable[[int, BaseException], None] | None = None):
        self.policy = policy
        self.events = events
        self.faults = faults
        self.sleep = sleep
        self.on_retry = on_retry
        self.saves = 0
        self._writer = AsyncCheckpointWriter(keep_prev=keep_prev)

    def save(self, directory, state, mesh, plan=None,
             block_layout: str = "canonical", step: int | None = None):
        def attempt():
            if self.faults.check("checkpoint_write", step) is not None:
                raise OSError(
                    f"injected checkpoint IO failure at step {step}")
            self._writer.save(directory, state, mesh, plan=plan,
                              block_layout=block_layout)
            self._writer.wait()

        self.policy.call(attempt, op="checkpoint_write", events=self.events,
                         sleep=self.sleep, on_retry=self.on_retry)
        self.saves += 1

    def close(self) -> None:
        self._writer.close()


@dataclass(frozen=True)
class RecoveryRecord:
    """One survived incident: what happened, where the run stood, where it
    resumed, and what the recovery cost."""

    kind: str  # "device_loss" | "spot_preemption" | "spot_return" | "anomaly_rollback"
    step: int  # step count when the incident hit
    resumed_step: int  # checkpointed step the run resumed from
    recover_s: float
    plan_changed: bool = False
    migrated: bool = False  # state resharded live (no checkpoint rollback)
    detail: str = ""


@dataclass
class SupervisorReport:
    """What a supervised run did — the chaos drill's assertion surface."""

    outcome: str  # "completed" | "preempted" | "failed"
    steps_done: int
    target_steps: int
    recoveries: list[RecoveryRecord] = field(default_factory=list)
    retries: int = 0
    checkpoints: int = 0
    final_loss: float | None = None
    losses: list[float] = field(default_factory=list)
    detail: str = ""

    def to_json_dict(self) -> dict:
        return {
            "outcome": self.outcome,
            "steps_done": self.steps_done,
            "target_steps": self.target_steps,
            "recoveries": [
                {"kind": r.kind, "step": r.step,
                 "resumed_step": r.resumed_step,
                 "recover_s": round(r.recover_s, 4),
                 "plan_changed": r.plan_changed,
                 "migrated": r.migrated, "detail": r.detail}
                for r in self.recoveries],
            "retries": self.retries,
            "checkpoints": self.checkpoints,
            "final_loss": self.final_loss,
            "detail": self.detail,
        }


# -- agreement over the process group ----------------------------------------------

def _from_rank0(value: float) -> float:
    """Rank 0's ``value`` on every rank."""
    from metis_tpu_torch.execution.reshard import _home

    if _world()[1] == 1:
        return value
    t = torch.tensor([value], dtype=torch.float64, device=_home())
    dist.broadcast(t, src=0)
    return float(t.item())


def _any_rank(flag: bool) -> bool:
    """Whether ``flag`` is set on any rank (one all-reduce)."""
    from metis_tpu_torch.execution.reshard import _home

    if _world()[1] == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=_home())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def _on_rank0(fn: Callable):
    """``fn()`` run on rank 0 (a plan search), its result on every rank;
    an exception it raises is raised on every rank (``_on_every_rank``)."""
    out = None
    if _world()[0] == 0:
        try:
            out = ("ok", fn())
        except Exception as e:  # noqa: BLE001 — every rank raises it below
            try:
                pickle.dumps(e)
            except Exception:  # noqa: BLE001 — sent as its text instead
                e = MetisError(f"{type(e).__name__}: {e}")
            out = ("error", e)
    if _world()[1] > 1:
        box = [out]
        dist.broadcast_object_list(box, src=0)
        out = box[0]
    if out[0] == "error":
        raise _on_every_rank(out[1])
    return out[1]


def _on_every_rank(err: Exception) -> Exception:
    """``err``, marked as raised on every rank at the same point of the
    loop, from the same inputs: the run fails on every rank together
    (``TrainingSupervisor.run``)."""
    err.on_every_rank = True
    return err


class _Built:
    """A plan built on this rank: the artifact, the executable (None on a
    rank outside the plan), its route and checkpoint block layout (the
    same on every rank), the input pipeline and the state."""

    def __init__(self, art: PlanArtifact, exe, kind: str, layout: str):
        self.art, self.exe, self.kind, self.layout = art, exe, kind, layout
        self.batches = None
        self.state = None

    @property
    def mesh(self):
        return self.exe.mesh if self.exe is not None else None

    def close(self) -> None:
        if self.batches is not None:
            self.batches.close()
            self.batches = None


class TrainingSupervisor:
    """Run ``steps`` training steps under full fault supervision, on this
    rank (module doc: every rank of the process group runs it).

    ``plan -> build -> (restore) -> step loop`` with the guards described in
    the module docstring.  The plan is pinned from ``checkpoint_dir`` when
    one was saved there (resume never silently retrains under a different
    layout); otherwise ``plan_hetero(top_k=1)`` picks it.

    ``faults`` injects scripted failures (``resilience/faults.py``);
    ``sleep`` is injectable so drills retry at full speed;
    ``install_signal_handler=True`` arms a real SIGTERM drain (CLI runs —
    tests use the ``preempt`` fault instead).  ``data_factory(artifact)``
    overrides the synthetic token stream.  ``device``: this rank's device
    (the CPU only when asked for); ``init``: the seed, or the full
    parameter tree, every fresh state is drawn from (the reference's
    ``PRNGKey(0)``).  ``decisions``: an ``obs.provenance.DecisionLog``
    each recovery is recorded in (rank 0 writes it; other ranks ignore
    theirs)."""

    def __init__(
        self,
        cluster: ClusterSpec,
        profiles: ProfileStore,
        model: ModelSpec,
        search_config: SearchConfig,
        *,
        checkpoint_dir: str | Path,
        steps: int,
        resilience: ResilienceConfig | None = None,
        faults: FaultInjector = NULL_INJECTOR,
        events: EventLog = NULL_LOG,
        data_factory: Callable[[PlanArtifact], object] | None = None,
        optimizer=None,
        install_signal_handler: bool = False,
        sleep: Callable[[float], None] = time.sleep,
        decisions=None,
        device: str | torch.device = "cuda",
        init=0,
    ):
        if steps < 1:
            raise ValueError("steps must be >= 1")
        self.cluster = cluster
        # the reference topology spot returns grow back toward; the live
        # ``self.cluster`` shrinks/grows within it across recoveries
        self.full_cluster = cluster
        self.profiles = profiles
        self.model = model
        self.search_config = search_config
        self.checkpoint_dir = Path(checkpoint_dir)
        self.steps = steps
        self.res = resilience or ResilienceConfig()
        self.faults = faults
        self.events = events
        self.data_factory = data_factory
        self.optimizer = optimizer
        self.install_signal_handler = install_signal_handler
        self._sleep = sleep
        self.device = resolve_device(device)
        self.init = init
        self.decisions = decisions if _world()[0] == 0 else None
        self._sigterm = False
        self._drain = False
        self._drain_reason = ""
        #: wall ms of each checkpoint save (retries included) and restore
        #: on this rank; not in the report, which is the reference's
        self.save_ms: list[float] = []
        self.restore_ms: list[float] = []
        #: the artifact JSON of every plan this run built, in order
        self.artifacts: list[str] = []

    # -- provenance helpers ------------------------------------------------

    def _recovery_root(self, cause: str, step: int, **detail) -> dict | None:
        """Record one recovery's ``cluster_delta`` root; the replan's
        decision_meta under it (None when no decision log is attached)."""
        if self.decisions is None:
            return None
        root = self.decisions.record(
            "cluster_delta", cause=cause, detail={"step": step, **detail})
        return {"cause": cause, "parent_seq": root.seq}

    def _record_migration(self, cause: str, fingerprint: str,
                          migrated: bool, step: int) -> None:
        if self.decisions is None:
            return
        parent = self.decisions.last_seq or None
        self.decisions.record(
            "migration_decision", plan_fingerprint=fingerprint,
            parent_seq=parent, cause=cause,
            detail={"path": "migrate" if migrated else "ckpt",
                    "resumed_step": step})

    # -- build helpers ----------------------------------------------------

    def _initial_artifact(self) -> PlanArtifact:
        pinned = None
        try:
            pinned = load_plan(self.checkpoint_dir)
        except FileNotFoundError:
            pinned = None
        if pinned is not None:
            return pinned
        return self._search_artifact(self.cluster)

    def _search_artifact(self, cluster: ClusterSpec) -> PlanArtifact:
        def search():
            result = plan_hetero(cluster, self.profiles, self.model,
                                 self.search_config, top_k=1, events=self.events)
            if result.best is not None:
                return PlanArtifact.from_ranked_plan(result.best).to_json()
            return None

        art = _on_rank0(search)
        if art is None:
            raise _on_every_rank(InfeasiblePlanError(
                f"no feasible plan for {cluster.total_devices} devices"))
        return PlanArtifact.from_json(art)

    def _build(self, art: PlanArtifact) -> _Built:
        from metis_tpu_torch.models import config_for_model_spec

        cfg = config_for_model_spec(self.model)
        schedule, vs = resolve_schedule(art)
        self.artifacts.append(art.to_json())
        exe = build_executable(
            cfg, art, self.device, optimizer=self.optimizer,
            cluster=self.cluster, profiles=self.profiles, schedule=schedule,
            virtual_stages=vs, events=self.events)
        # every rank, in the plan or not, decides on the same route
        kind = (exe.kind if exe is not None
                else plan_route(cfg, art, schedule, vs))
        return _Built(art, exe, kind,
                      checkpoint_block_layout(art, cfg, kind, schedule, vs))

    def _fresh(self, built: _Built):
        return built.exe.init(self.init) if built.exe is not None else None

    def _batches(self, built: _Built, skip: int) -> None:
        from metis_tpu_torch.data.pipeline import (
            make_input_pipeline,
            synthetic_run_dataset,
        )

        built.close()
        if built.exe is None:
            return
        if self.data_factory is not None:
            dataset = self.data_factory(built.art)
        else:
            dataset = synthetic_run_dataset(
                self.model.vocab_size, built.art.gbs,
                self.model.sequence_length)
        # every rank of the plan takes the full batch; the executable
        # keeps the rank's part
        built.batches = make_input_pipeline(
            dataset, built.art.gbs, device=self.device, epochs=None,
            skip_batches=skip)

    # -- checkpoint adapters ----------------------------------------------

    def _save(self, writer: RetryingCheckpointWriter, built: _Built,
              state, step: int) -> None:
        t0 = time.perf_counter()
        if built.kind == "hetero":
            def attempt():
                if self.faults.check("checkpoint_write", step) is not None:
                    raise OSError(
                        f"injected checkpoint IO failure at step {step}")
                save_hetero_checkpoint(self.checkpoint_dir, state, step,
                                       built.mesh, plan=built.art,
                                       keep_prev=self.res.keep_prev)

            writer.policy.call(attempt, op="checkpoint_write",
                               events=self.events, sleep=self._sleep,
                               on_retry=writer.on_retry)
            writer.saves += 1
        else:
            writer.save(self.checkpoint_dir,
                        None if state is None
                        else exec_state_to_train_state(built.kind, state, step),
                        built.art, plan=built.art, block_layout=built.layout,
                        step=step)
        self.save_ms.append((time.perf_counter() - t0) * 1e3)

    def _restore(self, built: _Built, reference_state):
        """(state, step) from the latest valid checkpoint generation, filled
        into ``reference_state`` in place (None on a rank outside the
        plan).  Raises ``FileNotFoundError`` when no checkpoint exists
        yet."""
        t0 = time.perf_counter()
        meta = load_meta(self.checkpoint_dir)
        if built.kind == "hetero":
            state = restore_hetero_checkpoint(self.checkpoint_dir,
                                              reference_state, built.mesh)
        else:
            ts = restore_checkpoint(
                self.checkpoint_dir,
                None if reference_state is None
                else exec_state_to_train_state(built.kind, reference_state,
                                               meta.step),
                expected_block_layout=built.layout, mesh=built.art)
            state = None if ts is None else train_state_to_exec_state(built.kind, ts)
        self.restore_ms.append((time.perf_counter() - t0) * 1e3)
        return state, meta.step

    def _switch_state(self, old: _Built, old_cluster: ClusterSpec,
                      built: _Built, fresh, step: int):
        """Carry the running state across a plan switch: ``(state, step,
        migrated)``.

        Prefers the live reshard (``execution/reshard.py``) when enabled,
        eligible, and priced under the checkpoint-restore baseline
        (``SearchConfig.spot_recover_s``); a successful migration keeps the
        CURRENT step.  Ineligibility or ANY mid-flight migration fault
        emits ``migration_fallback`` and degrades to checkpoint-restore —
        the switch is then exactly the pre-migration recovery path."""
        # imported here, not at module top: reshard.py consults the fault
        # injector, so a top-level import would close a cycle through
        # resilience/__init__
        from metis_tpu_torch.execution.reshard import (
            device_sets_intersect,
            execute_reshard,
            migration_eligible,
            stage_layout,
        )

        res = self.res
        if res.live_migration:
            try:
                ok, reason = migration_eligible(
                    _family(old.kind), _family(built.kind), old.layout,
                    built.layout, device_sets_intersect(old_cluster, self.cluster))
                if not ok:
                    raise MigrationError(reason)
                volume = TransformerVolume(
                    self.model, self.profiles.model.params_per_layer_bytes)
                path, price_ms = migration_decision(
                    stage_layout(old.art, self.model.num_layers),
                    stage_layout(built.art, self.model.num_layers),
                    volume, self.search_config.migration_bw_gbps,
                    self.search_config.spot_recover_s)
                if path != "migrate":
                    raise MigrationError(
                        f"priced transfer {price_ms:.1f} ms loses to "
                        f"checkpoint-restore "
                        f"{self.search_config.spot_recover_s * 1000.0:.1f}"
                        " ms")
                policy = RetryPolicy(max_attempts=res.retry_attempts,
                                     base_delay_s=res.retry_base_delay_s,
                                     max_delay_s=res.retry_max_delay_s)
                state, _ = execute_reshard(
                    old.state, fresh, step=step, events=self.events,
                    faults=self.faults, retry=policy, sleep=self._sleep)
                return state, step, True
            except (MetisError, OSError, ValueError) as e:
                self.events.emit("migration_fallback", step=step,
                                 reason=f"{type(e).__name__}: {e}")
        try:
            state, step = self._restore(built, fresh)
        except FileNotFoundError:
            state, step = fresh, 0
        return state, step, False

    # -- the supervised loop ----------------------------------------------

    def _handle_sigterm(self, signum, frame) -> None:  # pragma: no cover
        self._sigterm = True

    def run(self) -> SupervisorReport:
        res = self.res
        report = SupervisorReport(outcome="failed", steps_done=0,
                                  target_steps=self.steps)
        tracer = Tracer(self.events)
        detector = LossAnomalyDetector(spike_factor=res.spike_factor,
                                       window=res.spike_window)
        policy = RetryPolicy(max_attempts=res.retry_attempts,
                             base_delay_s=res.retry_base_delay_s,
                             max_delay_s=res.retry_max_delay_s)

        def count_retry(attempt, err):
            report.retries += 1

        writer = RetryingCheckpointWriter(
            policy, events=self.events, faults=self.faults,
            keep_prev=res.keep_prev, sleep=self._sleep,
            on_retry=count_retry)
        prev_handler = None
        if self.install_signal_handler:
            prev_handler = signal.signal(signal.SIGTERM, self._handle_sigterm)
        try:
            world = _world()[1]
            if world != self.cluster.total_devices:
                raise _on_every_rank(MetisError(
                    f"the supervisor runs one rank per device of the cluster: "
                    f"{self.cluster.total_devices} device(s), this process "
                    f"group has {world} rank(s)"))
            self._run_loop(report, tracer, detector, writer)
        except MetisError as e:
            if _world()[1] > 1 and not getattr(e, "on_every_rank", False):
                # this rank's alone (a corrupt file of its own): its peers
                # wait in the next collective, so the launch fails at once
                # (``execution.dist`` stops them) rather than this rank
                # reporting alone
                raise
            report.outcome = "failed"
            report.detail = f"{type(e).__name__}: {e}"
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
            try:
                writer.close()
            except Exception as e:  # noqa: BLE001 — keep the report
                if not report.detail:
                    report.detail = f"close: {type(e).__name__}: {e}"
        report.checkpoints = writer.saves
        if report.losses:
            report.final_loss = report.losses[-1]
        return report

    def _replace(self, built: _Built, skip: int, tokens_per_step: int):
        """The input pipeline and step timer of a run resumed at ``skip``."""
        self._batches(built, skip)
        return StepTimer(events=self.events, tokens_per_step=tokens_per_step,
                         start_step=skip)

    def _release(self, built: _Built) -> None:
        """Drop a plan switched away from: its pipeline, state, executable."""
        built.close()
        built.state = built.exe = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _recover(self, report: SupervisorReport, tracer: Tracer,
                 detector: LossAnomalyDetector, built: _Built, kind: str,
                 step: int, cluster: ClusterSpec, tokens_per_step: int,
                 moved: dict):
        """Switch to the plan searched on ``cluster`` (``moved``: the
        devices lost, or returned on a spot return): ``(built, timer,
        step, plan_changed, migrated)``."""
        cause = {"spot_preemption": "preemption"}.get(kind, kind)
        with tracer.span("recovery", kind=kind):
            old_cluster = self.cluster

            def search():
                meta = self._recovery_root(
                    cause, step, **{"added" if kind == "spot_return"
                                    else "removed": moved})
                rep = replan(self.cluster, cluster, self.profiles, self.model,
                             self.search_config, search_old=False,
                             decisions=self.decisions, decision_meta=meta)
                best = rep.result.best
                if best is None:
                    return rep.plan_changed, None, ""
                return (rep.plan_changed,
                        PlanArtifact.from_ranked_plan(best).to_json(),
                        fingerprint_ranked_plan(best))

            plan_changed, art, fingerprint = _on_rank0(search)
            if art is None:
                raise _on_every_rank(InfeasiblePlanError(
                    "no feasible plan on survivor topology" if kind != "spot_return"
                    else "no feasible plan on grown topology"))
            self.cluster = cluster
            new = self._build(PlanArtifact.from_json(art))
            fresh = self._fresh(new)
            new.state, step, migrated = self._switch_state(
                built, old_cluster, new, fresh, step)
            self._record_migration(cause, fingerprint, migrated, step)
            self._release(built)
            timer = self._replace(new, step, tokens_per_step)
            detector.reset()
        return new, timer, step, plan_changed, migrated

    def _run_loop(self, report: SupervisorReport, tracer: Tracer,
                  detector: LossAnomalyDetector,
                  writer: RetryingCheckpointWriter) -> None:
        from metis_tpu_torch.ops import flash_attention as fa

        res = self.res
        with tracer.span("supervised_run", steps=self.steps):
            with tracer.span("plan"):
                art = self._initial_artifact()
            with tracer.span("build"):
                built = self._build(art)
                built.state = self._fresh(built)
            step = 0
            try:
                built.state, step = self._restore(built, built.state)
            except FileNotFoundError:
                step = 0
            report.steps_done = step
            tokens_per_step = art.gbs * self.model.sequence_length
            timer = self._replace(built, step, tokens_per_step)

            try:
                while step < self.steps:
                    # -- device loss / spot eviction: checkpointed state +
                    #    survivors -> replan (spot evictions announce
                    #    themselves with a ``preemption`` event first)
                    kind = "device_loss"
                    spec = self.faults.check("device_loss", step)
                    if spec is None:
                        spec = self.faults.check("spot_preemption", step)
                        if spec is not None:
                            kind = "spot_preemption"
                    if spec is not None:
                        if len(report.recoveries) >= res.max_recoveries:
                            raise _on_every_rank(TrainingAnomalyError(
                                f"{len(report.recoveries)} recoveries exhausted "
                                f"max_recoveries={res.max_recoveries}"))
                        t0 = time.perf_counter()
                        lost = spec.lost_devices()
                        if not lost:
                            last = self.cluster.nodes[-1]
                            lost = {last.device_type: last.num_devices}
                        if kind == "spot_preemption":
                            self.events.emit(
                                "preemption", step=step, tier="spot",
                                lost=",".join(f"{t}={n}"
                                              for t, n in lost.items()))
                        survivor = shrink_cluster(self.cluster, lost)
                        built, timer, step, changed, migrated = self._recover(
                            report, tracer, detector, built, kind, step,
                            survivor, tokens_per_step, lost)
                        recover_s = _from_rank0(time.perf_counter() - t0)
                        self.events.emit(
                            "recovery_complete", step=step, kind=kind,
                            recover_s=round(recover_s, 4),
                            plan_changed=changed, migrated=migrated,
                            survivor_devices=survivor.total_devices)
                        report.recoveries.append(RecoveryRecord(
                            kind=kind, step=report.steps_done,
                            resumed_step=step, recover_s=recover_s,
                            plan_changed=changed, migrated=migrated,
                            detail=",".join(f"{t}={n}" for t, n in lost.items())))
                        report.steps_done = step
                        continue

                    # -- spot return: evicted capacity is back -> grow + replan
                    spec = self.faults.check("spot_return", step)
                    if spec is not None:
                        returned = spec.lost_devices()
                        if not returned:
                            # default: everything currently missing comes back
                            returned = dict(ClusterDelta.between(
                                self.cluster, self.full_cluster).added)
                        if returned:
                            if len(report.recoveries) >= res.max_recoveries:
                                raise _on_every_rank(TrainingAnomalyError(
                                    f"{len(report.recoveries)} recoveries "
                                    f"exhausted max_recoveries="
                                    f"{res.max_recoveries}"))
                            t0 = time.perf_counter()
                            self.events.emit(
                                "spot_return", step=step,
                                returned=",".join(f"{t}={n}"
                                                  for t, n in returned.items()))
                            grown = grow_cluster(
                                self.cluster, self.full_cluster, returned)
                            built, timer, step, changed, migrated = self._recover(
                                report, tracer, detector, built, "spot_return",
                                step, grown, tokens_per_step, returned)
                            recover_s = _from_rank0(time.perf_counter() - t0)
                            self.events.emit(
                                "recovery_complete", step=step,
                                kind="spot_return",
                                recover_s=round(recover_s, 4),
                                plan_changed=changed, migrated=migrated,
                                survivor_devices=grown.total_devices)
                            report.recoveries.append(RecoveryRecord(
                                kind="spot_return", step=report.steps_done,
                                resumed_step=step, recover_s=recover_s,
                                plan_changed=changed, migrated=migrated,
                                detail=",".join(f"{t}={n}"
                                                for t, n in returned.items())))
                            report.steps_done = step
                            continue

                    # -- preemption: finish in-flight work, checkpoint, exit;
                    #    the ranks agree on a SIGTERM any of them got
                    if _any_rank(self._sigterm) and not self._drain:
                        self._drain, self._drain_reason = True, "sigterm"
                    if self.faults.check("preempt", step) is not None:
                        self._drain = True
                        self._drain_reason = self._drain_reason or "preempt_fault"
                    if self._drain:
                        self.events.emit("preempt_drain", step=step,
                                         reason=self._drain_reason or "sigterm")
                        self._save(writer, built, built.state, step)
                        report.outcome = "preempted"
                        report.detail = self._drain_reason
                        return

                    # -- one training step (a rank outside the plan skips it
                    #    and takes rank 0's loss)
                    loss, launched = 0.0, {}
                    if built.exe is not None:
                        tokens, targets = next(built.batches)
                        fa.reset_launch_counts()
                        built.state, loss_t = built.exe.step(built.state, tokens,
                                                             targets)
                        loss = float(loss_t)
                        launched = {k: v for k, v in fa.launch_counts.items() if v}
                    loss = _from_rank0(loss)
                    if self.faults.check("loss_nan", step) is not None:
                        loss = float("nan")
                    if self.faults.check("loss_spike", step) is not None:
                        loss = abs(loss) * res.spike_factor * 10 + 1e3

                    kind = detector.observe(loss, step)
                    if kind == "nan":
                        self.events.emit("anomaly_detected", kind="nan",
                                         step=step, loss=str(loss))
                        if not res.restore_on_anomaly:
                            raise _on_every_rank(TrainingAnomalyError(
                                f"non-finite loss at step {step} and "
                                "restore_on_anomaly is off"))
                        if len(report.recoveries) >= res.max_recoveries:
                            raise _on_every_rank(TrainingAnomalyError(
                                f"non-finite loss at step {step}: "
                                f"max_recoveries={res.max_recoveries} exhausted"))
                        t0 = time.perf_counter()
                        with tracer.span("recovery", kind="anomaly_rollback"):
                            try:
                                # the optimizer stepped the state in place:
                                # it is the reference to restore into
                                built.state, resumed = self._restore(
                                    built, built.state)
                            except FileNotFoundError:
                                raise _on_every_rank(TrainingAnomalyError(
                                    f"non-finite loss at step {step} with no "
                                    "checkpoint to roll back to")) from None
                            timer = self._replace(built, resumed, tokens_per_step)
                            detector.reset()
                        recover_s = _from_rank0(time.perf_counter() - t0)
                        self.events.emit(
                            "recovery_complete", step=resumed,
                            kind="anomaly_rollback",
                            recover_s=round(recover_s, 4), plan_changed=False)
                        report.recoveries.append(RecoveryRecord(
                            kind="anomaly_rollback", step=step,
                            resumed_step=resumed, recover_s=recover_s))
                        step = resumed
                        report.steps_done = step
                        continue
                    if kind == "spike":
                        self.events.emit("anomaly_detected", kind="spike",
                                         step=step, loss=loss)

                    step += 1
                    report.steps_done = step
                    report.losses.append(loss)
                    timer.record(loss, **({"kernel_launches": launched}
                                          if launched else {}))
                    if (res.checkpoint_every
                            and step % res.checkpoint_every == 0
                            and step < self.steps):
                        self._save(writer, built, built.state, step)

                # -- completed: land the final checkpoint
                self._save(writer, built, built.state, step)
                report.outcome = "completed"
            finally:
                built.close()


def _no_sleep(_s: float) -> None:
    """Retry backoff that does not wait (drills)."""


def supervised_rank(rank: int, device: torch.device, job: dict,
                    events: EventLog | None = None) -> dict:
    """One rank of a supervised run (``execution.dist.spawn``'s body, or
    the whole run on one device): ``job`` holds the ``cluster``
    (``ClusterSpec``), ``profile_dir``, ``model``, ``config``
    (``SearchConfig``), ``resilience``, ``fault_script`` and its ``seed``,
    ``checkpoint_dir``, ``steps``, and optionally ``events`` (a path; rank
    0 writes it), ``decisions`` (a decision log's path; rank 0 writes it),
    ``data`` (a token file), ``init``, ``no_sleep`` and
    ``install_signal_handler``.  Returns host data: ``report``
    (``SupervisorReport.to_json_dict``), ``losses``, ``fired`` (the
    injected faults), ``artifacts`` (the plans built), ``save_ms`` and
    ``restore_ms``, and ``total_devices`` (the size of the cluster the run
    ended on, grown back after a ``spot_return``).  ``events``: rank 0's
    open log, in place of ``job["events"]`` (a run on one device in the
    caller's process)."""
    import numpy as np

    from metis_tpu_torch.data.pipeline import TokenDataset

    own = events is None
    if own:
        events = (EventLog(job["events"]) if job.get("events") and rank == 0
                  else NULL_LOG)
    faults = FaultInjector(job.get("fault_script") or "", seed=job.get("seed", 0),
                           events=events)
    data_factory = None
    if job.get("data"):
        path = job["data"]

        def data_factory(art):
            tokens = (np.load(path, mmap_mode="r") if path.endswith(".npy")
                      else np.memmap(path, dtype=np.int32, mode="r"))
            return TokenDataset(tokens, job["model"].sequence_length)

    decisions = None
    if job.get("decisions") and rank == 0:
        from metis_tpu_torch.obs.provenance import DecisionLog

        decisions = DecisionLog(job["decisions"])
    try:
        supervisor = TrainingSupervisor(
            job["cluster"], ProfileStore.from_dir(job["profile_dir"]),
            job["model"], job["config"], checkpoint_dir=job["checkpoint_dir"],
            steps=job["steps"], resilience=job.get("resilience"),
            faults=faults, events=events, data_factory=data_factory,
            install_signal_handler=job.get("install_signal_handler", False),
            sleep=_no_sleep if job.get("no_sleep") else time.sleep,
            device=device, init=job.get("init", 0), decisions=decisions)
        report = supervisor.run()
    finally:
        if own:
            events.close()
        if decisions is not None:
            decisions.close()
    return {"report": report.to_json_dict(), "losses": list(report.losses),
            "fired": list(faults.fired), "artifacts": supervisor.artifacts,
            "save_ms": supervisor.save_ms,
            "restore_ms": supervisor.restore_ms,
            "total_devices": supervisor.cluster.total_devices}
