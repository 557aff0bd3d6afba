"""Chaos harness: kill the scheduler at every span boundary, converge.

Port of ``dcos_commons_tpu/testing/chaos.py``, line for line but the
imports and the GPU fleet: the service's gang asks for a ``gpu:``
block, and the fleets are NVLink nodes of four cards.

Reference: the reference proves restart safety with ONE restart test
(``SchedulerRestartServiceTest``); this harness turns that into a
kill MATRIX.  A crash injector raises out of ``run_cycle`` at a
chosen traceview span-boundary kind — the five places a scheduler
death leaves observably different persisted state:

    post-evaluate        evaluation passed, nothing persisted
    post-wal             reservations + launch WAL durable, agent
                         never heard about the launch
    mid-status-fan-in    a status persisted but not routed to plans
    mid-plan-transition  a plan step moved, post-transition work lost
    mid-checkpoint-prune plan checkpoints partially written/pruned

The dead scheduler object is abandoned exactly as SIGKILL would leave
a process (no cleanup, spans leaked, locks simply released), a
successor is rebuilt over the same persister + agent + inventory —
the production failover path — and the harness drives cycles until
the plan converges, then asserts the invariants split-brain-free
failover promises: the plan completes, no card is double-reserved, no
task is orphaned, and no step that was COMPLETE before the kill runs
again.

Deterministic: kills fire at exact occurrence counts of exact kinds;
``ChaosMatrix`` derives its schedule from a seed recorded in every
report, so a failing combination replays from the log line alone.

The five hand-wired kinds above are the HISTORY; the durcheck
analyzer (``analysis dur --points``) now emits the full persistence-
point map — every WAL/store/property/persister/delete boundary it
discovered statically — and ``AutoChaosMatrix`` turns each one into a
crash-injection point: a ``PersisterCrashProxy`` wraps the harness
persister, stack-matches every mutation against the map (marking
coverage), and dies immediately BEFORE the targeted mutation — the
crash window ``dur-effect-before-wal`` reasons about.  A coverage
probe run first separates reachable boundaries from unreachable
ones; unreachable boundaries are REPORTED in the result, never
silently skipped, so the map stays probe-verified.
"""

from __future__ import annotations

import os
import random
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from dcos_commons_tpu_torch.common import TaskState, TaskStatus
from dcos_commons_tpu_torch.offer.inventory import GpuHost, SliceInventory
from dcos_commons_tpu_torch.scheduler.builder import SchedulerBuilder
from dcos_commons_tpu_torch.scheduler.config import SchedulerConfig
from dcos_commons_tpu_torch.scheduler.scheduler import DefaultScheduler
from dcos_commons_tpu_torch.specification.yaml_spec import from_yaml
from dcos_commons_tpu_torch.storage import MemPersister
from dcos_commons_tpu_torch.testing.fake_agent import FakeAgent

# the five span-boundary kinds DefaultScheduler exposes via
# _chaos_point (keep in lockstep with the call sites there and in
# ha/rehydrate.PlanCheckpointer)
CHAOS_KINDS = (
    "post-evaluate",
    "post-wal",
    "mid-status-fan-in",
    "mid-plan-transition",
    "mid-checkpoint-prune",
)


class SchedulerKilled(BaseException):
    """Raised by a CrashInjector: the scheduler 'process' died here.
    A ``BaseException`` on purpose — it models SIGKILL, and a
    catch-all ``except Exception`` telemetry guard (health observe,
    journal flush) must not be able to 'survive' process death."""

    def __init__(self, kind: str, occurrence: int):
        super().__init__(f"chaos kill at {kind} (occurrence {occurrence})")
        self.kind = kind
        self.occurrence = occurrence


@dataclass(frozen=True)
class KillPoint:
    """Die at the Nth time ``kind`` is reached (1-based)."""

    kind: str
    occurrence: int = 1

    def __post_init__(self):
        if self.kind not in CHAOS_KINDS:
            raise ValueError(
                f"unknown chaos kind {self.kind!r}; expected one of "
                f"{CHAOS_KINDS}"
            )


class CrashInjector:
    """Installed as ``scheduler.chaos``; counts hits per kind and
    raises once at the scheduled point."""

    def __init__(self, point: KillPoint):
        self.point = point
        self.hits: Dict[str, int] = {}
        self.fired = False

    def __call__(self, kind: str) -> None:
        self.hits[kind] = self.hits.get(kind, 0) + 1
        if (not self.fired and kind == self.point.kind
                and self.hits[kind] == self.point.occurrence):
            self.fired = True
            raise SchedulerKilled(kind, self.point.occurrence)


@dataclass
class ChaosReport:
    """One kill-and-converge run's observable outcome."""

    kill: Optional[KillPoint]
    seed: int = 0
    killed: bool = False
    incarnations: int = 1
    cycles: int = 0
    converged: bool = False
    # persisted view at the moment of death
    prekill_complete_steps: List[Tuple[str, str, str]] = field(
        default_factory=list
    )
    prekill_task_ids: Dict[str, str] = field(default_factory=dict)
    prekill_staging_ids: Dict[str, str] = field(default_factory=dict)
    # successor's first-cycle WAL replay
    rehydration: Optional[dict] = None
    # converged view
    final_task_ids: Dict[str, str] = field(default_factory=dict)

    def describe(self) -> str:
        kill = (f"{self.kill.kind}#{self.kill.occurrence}"
                if self.kill else "none")
        return (
            f"chaos[kill={kill} seed={self.seed} killed={self.killed} "
            f"incarnations={self.incarnations} cycles={self.cycles} "
            f"converged={self.converged} rehydration={self.rehydration}]"
        )


# a control pod that deploys (and completes) BEFORE the gang, so every
# kill during the gang's rollout has a completed step to regress — the
# no-completed-step-re-run invariant needs one to exist
CHAOS_GANG_YAML = """
name: chaossvc
pods:
  ctl:
    count: 1
    tasks:
      server:
        goal: RUNNING
        cmd: "{cmd}"
        cpus: 0.5
        memory: 64
  trainer:
    count: 4
    gang: true
    gpu:
      generation: h100
      chips-per-host: 4
      topology: 4x4
    tasks:
      worker:
        goal: RUNNING
        cmd: "{cmd}"
        cpus: 1.0
        memory: 256
"""


# the multi-slice storm target: one gang spanning two 4x4 fabrics
# over DCN, elastic so a whole-fabric loss can shrink the dcn axis
# instead of waiting for capacity that never returns
CHAOS_MULTISLICE_YAML = """
name: chaossvc
pods:
  ctl:
    count: 1
    tasks:
      server:
        goal: RUNNING
        cmd: "{cmd}"
        cpus: 0.5
        memory: 64
  trainer:
    count: 8
    gang: true
    gpu:
      generation: h100
      chips-per-host: 4
      topology: 4x4
      slices: 2
      elastic: true
      min-hosts: 4
    tasks:
      worker:
        goal: RUNNING
        cmd: "{cmd}"
        cpus: 1.0
        memory: 256
"""


def chaos_fleet() -> List[GpuHost]:
    """Four NVLink nodes of four cards: one fabric, the 4-host gang."""
    from dcos_commons_tpu_torch.offer.inventory import make_test_fleet

    return make_test_fleet(nodes=4, gpus=4,  # sdklint: disable=no-gpus-resource — a host's card count, not a task resource
                           cpus=16.0, memory_mb=65536)


class ChaosHarness:
    """Drive one service through deploy, killing and restarting the
    scheduler at a chosen point.

    Two agent modes share every other code path:

    * ``workdir=None`` — a ``FakeAgent``; the harness acks launches
      RUNNING between cycles.  Fast and fully deterministic: the
      tier-1 single-kill tests run here.
    * ``workdir=<dir>`` — a real ``LocalProcessAgent`` launching real
      task processes that SURVIVE scheduler death (durable-task
      semantics), exactly like a production failover.  The chaos-tier
      matrix runs here.
    """

    def __init__(
        self,
        yaml_text: Optional[str] = None,
        hosts: Optional[List[GpuHost]] = None,
        workdir: Optional[str] = None,
        seed: int = 0,
        task_cmd: str = "sleep 120",
    ):
        yaml_text = (yaml_text or CHAOS_GANG_YAML).replace(
            "{cmd}", task_cmd
        )
        self.spec = from_yaml(yaml_text)
        self.hosts = hosts if hosts is not None else chaos_fleet()
        self.seed = seed
        self.persister = MemPersister()
        self.inventory = SliceInventory(self.hosts)
        self.config = SchedulerConfig(
            backoff_enabled=False, revive_capacity=10**9
        )
        self.local_mode = workdir is not None
        if self.local_mode:
            from dcos_commons_tpu_torch.agent.local import LocalProcessAgent

            self.agent = LocalProcessAgent(workdir)
        else:
            self.agent = FakeAgent()
            self._acked: set = set()
        self.scheduler: Optional[DefaultScheduler] = None

    # -- lifecycle ----------------------------------------------------

    def build_scheduler(self) -> DefaultScheduler:
        builder = SchedulerBuilder(self.spec, self.config, self.persister)
        builder.set_inventory(self.inventory)
        builder.set_agent(self.agent)
        self.scheduler = builder.build()
        return self.scheduler

    def shutdown(self) -> None:
        """Kill surviving task processes (local mode) — durable tasks
        outlive every scheduler incarnation by design."""
        shutdown = getattr(self.agent, "shutdown", None)
        if callable(shutdown):
            shutdown()

    # -- the kill-and-converge loop -----------------------------------

    def _ack_fake_launches(self) -> None:
        for info in list(self.agent.launched):
            if info.task_id not in self._acked:
                self._acked.add(info.task_id)
                self.agent.send(TaskStatus(
                    task_id=info.task_id, state=TaskState.RUNNING,
                    ready=True, agent_id=info.agent_id,
                ))

    def _snapshot_persisted(self, report: ChaosReport) -> None:
        """The successor's whole world: what the STORE says at death."""
        from dcos_commons_tpu_torch.state.state_store import StateStore

        store = StateStore(self.persister)
        statuses = store.fetch_statuses()
        for name, status in statuses.items():
            if status.state is TaskState.STAGING:
                report.prekill_staging_ids[name] = status.task_id
            elif not status.state.is_terminal:
                report.prekill_task_ids[name] = status.task_id

    def _snapshot_plans(self, scheduler, report: ChaosReport) -> None:
        for plan_name, plan in scheduler.plans().items():
            for phase in plan.phases:
                for step in phase.steps:
                    if step.get_status().is_complete:
                        report.prekill_complete_steps.append(
                            (plan_name, phase.name, step.name)
                        )

    def run(
        self,
        kill: Optional[KillPoint],
        timeout_s: float = 60.0,
        settle_s: float = 0.02,
    ) -> ChaosReport:
        """Deploy to completion, dying once at ``kill`` (when given).
        Raises on non-convergence; requesting a kill that never fires
        is an error too (a silently-skipped matrix entry would read as
        coverage)."""
        report = ChaosReport(kill=kill, seed=self.seed)
        scheduler = self.scheduler or self.build_scheduler()
        if kill is not None:
            scheduler.chaos = CrashInjector(kill)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                scheduler.run_cycle()
            except SchedulerKilled:
                # the 'process' died: snapshot the persisted world the
                # successor inherits, abandon the corpse (no cleanup —
                # that is the point), and fail over
                report.killed = True
                self._snapshot_plans(scheduler, report)
                self._snapshot_persisted(report)
                scheduler = self.build_scheduler()  # successor
                report.incarnations += 1
                continue
            report.cycles += 1
            if report.killed and report.rehydration is None:
                report.rehydration = scheduler.last_rehydration
            if not self.local_mode:
                self._ack_fake_launches()
            if scheduler.deploy_manager.get_plan().is_complete:
                report.converged = True
                break
            if self.local_mode:
                time.sleep(settle_s)  # real processes need wall time
        if kill is not None and not report.killed:
            raise AssertionError(
                f"kill point {kill} never fired: {report.describe()}"
            )
        for info in scheduler.state_store.fetch_tasks():
            report.final_task_ids[info.name] = info.task_id
        self.assert_invariants(scheduler, report)
        return report

    # -- the failover invariants --------------------------------------

    def assert_invariants(self, scheduler, report: ChaosReport) -> None:
        describe = report.describe()
        assert report.converged, f"plan never converged: {describe}"

        # 1. no double reservation: every card claimed at most once,
        #    and every reservation is owned by a stored task
        claimed: Dict[tuple, str] = {}
        stored_names = {
            info.name for info in scheduler.state_store.fetch_tasks()
        }
        for reservation in scheduler.ledger.all():
            assert reservation.task_name in stored_names, (
                f"reservation {reservation.reservation_id} owned by "
                f"unknown task {reservation.task_name}: {describe}"
            )
            for chip in reservation.chip_ids:
                key = (reservation.host_id, chip)
                assert key not in claimed or \
                    claimed[key] == reservation.reservation_id, (
                        f"card {key} double-reserved: {describe}"
                    )
                claimed[key] = reservation.reservation_id
        if report.rehydration is not None:
            assert report.rehydration["double_reservations"] == 0, describe

        # 2. no orphaned task: agent reality == store reality
        stored_ids = {
            info.task_id
            for info in scheduler.state_store.fetch_tasks()
        }
        active = scheduler.agent.active_task_ids()
        assert active <= stored_ids, (
            f"orphaned agent tasks {active - stored_ids}: {describe}"
        )
        # ...and every live stored task is actually running somewhere
        for name, status in scheduler.state_store.fetch_statuses().items():
            if status.state is TaskState.RUNNING:
                assert status.task_id in active, (
                    f"store believes {name} runs as {status.task_id} "
                    f"but no agent does: {describe}"
                )

        # 3. no completed step re-ran: tasks of steps COMPLETE before
        #    the kill keep their task ids through the failover
        for plan_name, phase_name, step_name in \
                report.prekill_complete_steps:
            plan = scheduler.plan(plan_name)
            if plan is None:
                continue  # deploy renamed to update across restart
            step = plan.step(phase_name, step_name)
            assert step is not None and step.get_status().is_complete, (
                f"step {plan_name}/{phase_name}/{step_name} was "
                f"COMPLETE before the kill but is "
                f"{step.get_status() if step else 'GONE'} after: "
                f"{describe}"
            )
        for name, task_id in report.prekill_task_ids.items():
            final = report.final_task_ids.get(name)
            assert final == task_id, (
                f"running task {name} was re-launched across the "
                f"failover ({task_id} -> {final}): {describe}"
            )

        # 4. WAL consistency: every stored info has a status for ITS id
        for info in scheduler.state_store.fetch_tasks():
            status = scheduler.state_store.fetch_status(info.name)
            assert status is not None and \
                status.task_id == info.task_id, (
                    f"WAL'd task {info.name} has no status for its "
                    f"launch: {describe}"
                )

    # -- auto-derived boundary runs (durcheck persistence points) -----

    def run_boundary(
        self,
        proxy: "PersisterCrashProxy",
        timeout_s: float = 60.0,
        settle_s: float = 0.02,
    ) -> "BoundaryReport":
        """Like ``run``, but the killer is a ``PersisterCrashProxy``
        already installed as ``self.persister`` instead of a span-kind
        injector.  Differences the boundary semantics force:

        * ``build_scheduler`` runs INSIDE the try — rehydrate and
          builder mutations cross persistence boundaries too, and a
          targeted boundary may only be reachable there.
        * at death the report additionally records the **unWAL'd
          effects**: agent-active task ids the store has no record of.
          Zero for the healthy scheduler at every boundary (the proxy
          dies BEFORE the mutation, so the crash window is maximal) —
          nonzero exactly when an effect escaped ahead of its WAL,
          which is what the seeded-bug fixture demonstrates.

        With ``proxy.target`` None this is the coverage probe: a
        healthy converging run that marks every boundary the harness
        actually crosses in ``proxy.covered``."""
        from dcos_commons_tpu_torch.state.state_store import StateStore

        report = ChaosReport(kill=None, seed=self.seed)
        boundary = BoundaryReport(point=proxy.target, report=report)
        scheduler = self.scheduler
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                if scheduler is None:
                    scheduler = self.build_scheduler()
                scheduler.run_cycle()
            except SchedulerKilled:
                report.killed = True
                if scheduler is not None:
                    self._snapshot_plans(scheduler, report)
                self._snapshot_persisted(report)
                stored_ids = {
                    info.task_id
                    for info in StateStore(self.persister).fetch_tasks()
                }
                active = set(self.agent.active_task_ids())
                boundary.unwald_at_death = sorted(active - stored_ids)
                scheduler = None  # successor rebuilt inside the try
                # Mesos-style status reconciliation: the successor asks
                # the agent to re-send task state, so a status consumed
                # but killed before its store write is re-delivered
                # (span-kind kills never die mid-status, so ``run``
                # does not need this).  The fake agent's re-send is
                # this harness's acks; a LocalProcessAgent re-arms its
                # own on the successor's reconcile().
                if not self.local_mode:
                    self._acked.clear()
                report.incarnations += 1
                continue
            report.cycles += 1
            if report.killed and report.rehydration is None:
                report.rehydration = scheduler.last_rehydration
            if not self.local_mode:
                self._ack_fake_launches()
            if scheduler.deploy_manager.get_plan().is_complete:
                report.converged = True
                # a targeted boundary may belong to a wall-clock
                # periodic writer (health journal flushes): keep the
                # converged world running until the kill fires, so a
                # point the probe reached is never lost to deploy-vs-
                # interval jitter.  The deadline still bounds a target
                # that genuinely cannot fire.
                if proxy.target is None or report.killed:
                    break
            if self.local_mode:
                time.sleep(settle_s)
        if proxy.target is not None and not report.killed:
            raise AssertionError(
                f"auto boundary {proxy.target} never fired: "
                f"{report.describe()}"
            )
        for info in scheduler.state_store.fetch_tasks():
            report.final_task_ids[info.name] = info.task_id
        self.assert_invariants(scheduler, report)
        return boundary


# -- host-level preemption storms ---------------------------------------

# synthetic triggers beyond the span-boundary kinds:
#   STORM_START      immediately after the healthy deploy completes —
#                    the storm's initiating loss (span boundaries only
#                    fire while the scheduler has work, so the FIRST
#                    preemption cannot ride one)
#   RECOVERY_ACTIVE  the first cycle boundary where the recovery plan
#                    holds incomplete work — the storm-within-recovery
#                    case (a second host dies while the first loss's
#                    gang recovery plan is mid-flight)
STORM_START = "start"
RECOVERY_ACTIVE = "recovery-active"


@dataclass(frozen=True)
class PreemptSpec:
    """Preempt ``hosts`` gang-carrying hosts when ``at`` fires for the
    ``occurrence``-th time.  ``at`` is a span-boundary kind from
    CHAOS_KINDS (the preemption lands MID-CYCLE, exactly where a
    cloud reclaim would; counting starts once the storm is armed,
    post-deploy), STORM_START, or RECOVERY_ACTIVE.
    ``kill_scheduler`` also crashes the scheduler at the same
    boundary — preemption and failover composed.

    ``whole_slice`` reinterprets ``hosts`` as a SLICE count: each
    victim is one entire fabric (``slice_id``) of a multi-slice gang
    — every host in the fabric dies physically, statuses never
    arrive — the cloud-reclaim unit a dcn-spanning gang actually
    loses."""

    at: str = STORM_START
    occurrence: int = 1
    hosts: int = 1
    kill_scheduler: bool = False
    whole_slice: bool = False

    def __post_init__(self):
        allowed = CHAOS_KINDS + (STORM_START, RECOVERY_ACTIVE)
        if self.at not in allowed:
            raise ValueError(
                f"unknown preemption trigger {self.at!r}; expected one "
                f"of {allowed}"
            )


@dataclass
class StormReport:
    specs: Tuple[PreemptSpec, ...]
    seed: int = 0
    preempted: List[str] = field(default_factory=list)
    incarnations: int = 1
    cycles: int = 0
    converged: bool = False
    recoveries_seen: int = 0
    final_task_ids: Dict[str, str] = field(default_factory=dict)
    final_hosts: Dict[str, str] = field(default_factory=dict)

    def describe(self) -> str:
        return (
            f"storm[specs={list(self.specs)} seed={self.seed} "
            f"preempted={self.preempted} "
            f"incarnations={self.incarnations} cycles={self.cycles} "
            f"converged={self.converged}]"
        )


class _StormInjector:
    """Installed as ``scheduler.chaos``: at the scheduled span
    boundary it PHYSICALLY preempts K gang hosts (agent processes die
    silently, inventory marks the capacity gone) — and optionally
    raises SchedulerKilled on top.  Detection (the LOST synthesis) is
    deliberately NOT done here: it happens at the next cycle boundary
    through the same verb path production uses, so the window where
    the store still believes in dead tasks is part of the test."""

    def __init__(self, storm: "PreemptionStorm",
                 specs: List[PreemptSpec]):
        self.storm = storm
        self.specs = list(specs)
        self.hits: Dict[str, int] = {}

    def __call__(self, kind: str) -> None:
        self.hits[kind] = self.hits.get(kind, 0) + 1
        fired = [
            spec for spec in self.specs
            if spec.at == kind and self.hits[kind] == spec.occurrence
        ]
        for spec in fired:
            self.specs.remove(spec)
            self.storm.preempt_now(
                spec.hosts, whole_slice=spec.whole_slice
            )
            if spec.kill_scheduler:
                raise SchedulerKilled(kind, spec.occurrence)


# three fabrics of four 4-card nodes so a 4-host gang can re-place
# twice (the storm's second preemption lands on the replacement fabric)
def storm_fleet(slices: int = 3) -> List[GpuHost]:
    from dcos_commons_tpu_torch.offer.inventory import make_test_fleet

    hosts: List[GpuHost] = []
    for i in range(slices):
        hosts += make_test_fleet(
            f"fabric-{i}", nodes=4, gpus=4,  # sdklint: disable=no-gpus-resource — a host's card count, not a task resource
            cpus=16.0, memory_mb=65536,
        )
    return hosts


class PreemptionStorm:
    """Deploy a gang, storm it with host preemptions at chosen span
    boundaries (optionally composed with scheduler kills), converge,
    and assert the gang-recovery invariants: zero double-reservations,
    zero reservations left on preempted hosts, and EXACTLY ONE gang
    incarnation running at the end (every older launch's processes
    dead, every current task adopted by exactly one agent process).
    FakeAgent mode — fast and deterministic, tier-1-runnable."""

    def __init__(
        self,
        specs: List[PreemptSpec],
        yaml_text: Optional[str] = None,
        hosts: Optional[List[GpuHost]] = None,
        seed: int = 0,
        gang_pod: str = "trainer",
    ):
        self.specs = list(specs)
        self.gang_pod = gang_pod
        self.harness = ChaosHarness(
            yaml_text=yaml_text or CHAOS_GANG_YAML,
            hosts=hosts if hosts is not None else storm_fleet(),
            seed=seed,
        )
        self.agent = self.harness.agent
        self.scheduler: Optional[DefaultScheduler] = None
        self.report = StormReport(specs=tuple(self.specs), seed=seed)
        # preempted but not yet surfaced to the scheduler (the
        # detection gap between the physical loss and the verb)
        self._unnotified: set = set()
        self._acked: set = set()

    # -- injector callbacks -------------------------------------------

    def preempt_now(self, k: int, whole_slice: bool = False) -> None:
        """Physically preempt up to ``k`` gang-carrying hosts NOW.

        ``whole_slice`` reinterprets ``k`` as a count of SLICES: each
        victim slice loses EVERY host (gang-carrying or not) — the
        reclaim granularity a multi-slice gang sees when a provider
        takes back one slice of its dcn span."""
        scheduler = self.scheduler
        assert scheduler is not None
        by_host: Dict[str, int] = {}
        for info in scheduler.state_store.fetch_tasks():
            if info.pod_type == self.gang_pod:
                by_host[info.agent_id] = by_host.get(info.agent_id, 0) + 1
        victims = [
            h for h in sorted(by_host)
            if scheduler.inventory.host_state(h) != "preempted"
        ]
        if whole_slice:
            dead_slices: List[str] = []
            for h in victims:
                host = scheduler.inventory.host(h)
                sid = host.slice_id if host is not None else ""
                if sid and sid not in dead_slices:
                    dead_slices.append(sid)
            dead_slices = dead_slices[:k]
            victims = sorted(
                h.host_id for h in scheduler.inventory.hosts()
                if h.slice_id in dead_slices
                and scheduler.inventory.host_state(h.host_id)
                != "preempted"
            )
        else:
            victims = victims[:k]
        for host_id in victims:
            self.agent.fail_host(host_id)
            scheduler.inventory.set_preempted(host_id)
            self.report.preempted.append(host_id)
            self._unnotified.add(host_id)

    # -- the storm loop -----------------------------------------------

    def _gang_task_names(self, scheduler) -> List[str]:
        pod = scheduler.spec.pod(self.gang_pod)
        return [
            f"{pod.type}-{i}-{t.name}"
            for i in range(pod.count)
            for t in pod.tasks
        ]

    def _ack_staging(self, scheduler) -> None:
        for info in list(self.agent.launched):
            if info.task_id in self._acked:
                continue
            if info.task_id not in self.agent.active_task_ids():
                continue  # preempted before it could report
            status = scheduler.state_store.fetch_status(info.name)
            if status is not None and status.task_id == info.task_id \
                    and status.state is TaskState.STAGING:
                self._acked.add(info.task_id)
                self.agent.send(TaskStatus(
                    task_id=info.task_id, state=TaskState.RUNNING,
                    ready=True, agent_id=info.agent_id,
                ))

    def _recovery_in_flight(self, scheduler) -> bool:
        plan = scheduler.plan("recovery")
        return plan is not None and bool(plan.phases) \
            and not plan.is_complete

    def _gang_converged(self, scheduler) -> bool:
        if self._recovery_in_flight(scheduler):
            return False
        active = scheduler.agent.active_task_ids()
        names = self._gang_task_names(scheduler)
        seen = 0
        for name in names:
            info = scheduler.state_store.fetch_task(name)
            if info is None:
                continue  # trimmed by an elastic shrink
            status = scheduler.state_store.fetch_status(name)
            if status is None or status.task_id != info.task_id or \
                    status.state is not TaskState.RUNNING or \
                    info.task_id not in active:
                return False
            seen += 1
        return seen > 0

    def run(self, timeout_s: float = 60.0) -> StormReport:
        scheduler = self.harness.build_scheduler()
        self.scheduler = scheduler
        report = self.report
        deadline = time.monotonic() + timeout_s
        # phase 1: the healthy deploy, chaos-free — the storm hits a
        # RUNNING gang, not a rollout
        while time.monotonic() < deadline:
            scheduler.run_cycle()
            report.cycles += 1
            self._ack_staging(scheduler)
            if scheduler.deploy_manager.get_plan().is_complete:
                break
        assert scheduler.deploy_manager.get_plan().is_complete, (
            f"deploy never completed before the storm: "
            f"{report.describe()}"
        )
        # phase 2: arm the storm.  Span-boundary occurrence counting
        # starts HERE, so `post-evaluate occurrence 1` means the first
        # post-evaluate the storm's own recovery work causes.
        injector = _StormInjector(
            self,
            [s for s in self.specs
             if s.at not in (RECOVERY_ACTIVE, STORM_START)],
        )
        recovery_specs = [
            s for s in self.specs if s.at == RECOVERY_ACTIVE
        ]
        recovery_hits = 0
        scheduler.chaos = injector
        for spec in [s for s in self.specs if s.at == STORM_START]:
            self.preempt_now(spec.hosts, whole_slice=spec.whole_slice)
            if spec.kill_scheduler:
                report.incarnations += 1
                scheduler = self.harness.build_scheduler()
                self.scheduler = scheduler
                scheduler.chaos = injector
        while time.monotonic() < deadline:
            try:
                scheduler.run_cycle()
                report.cycles += 1
                # detection: surface physical preemptions through the
                # production verb path (stamp + LOST + gang recovery).
                # Inside the try: the verb routes statuses through the
                # same span boundaries, so a kill_scheduler spec can
                # fire HERE too — that is a real failover timing
                for host_id in sorted(self._unnotified):
                    # discard AFTER the verb completes: a scheduler
                    # kill mid-verb leaves the host unnotified and
                    # the successor repeats the (idempotent) verb
                    scheduler.note_host_preempted(host_id)
                    self._unnotified.discard(host_id)
                if recovery_specs and self._recovery_in_flight(scheduler):
                    recovery_hits += 1
                    fired = [
                        s for s in recovery_specs
                        if s.occurrence == recovery_hits
                    ]
                    for spec in fired:
                        recovery_specs.remove(spec)
                        self.preempt_now(
                            spec.hosts, whole_slice=spec.whole_slice
                        )
            except SchedulerKilled:
                # failover composed with the preemption: successor
                # over the same persister + inventory + agent
                report.incarnations += 1
                scheduler = self.harness.build_scheduler()
                self.scheduler = scheduler
                scheduler.chaos = injector
                continue
            if self._recovery_in_flight(scheduler):
                report.recoveries_seen += 1
            self._ack_staging(scheduler)
            if not injector.specs and not recovery_specs and \
                    not self._unnotified and \
                    scheduler.deploy_manager.get_plan().is_complete and \
                    self._gang_converged(scheduler):
                report.converged = True
                break
        if injector.specs or recovery_specs:
            raise AssertionError(
                f"preemption trigger(s) never fired: "
                f"{injector.specs + recovery_specs}: {report.describe()}"
            )
        for info in scheduler.state_store.fetch_tasks():
            report.final_task_ids[info.name] = info.task_id
            report.final_hosts[info.name] = info.agent_id
        self.assert_invariants(scheduler, report)
        return report

    # -- the preemption invariants ------------------------------------

    def assert_invariants(self, scheduler, report: StormReport) -> None:
        describe = report.describe()
        assert report.converged, f"storm never converged: {describe}"

        # 1. no reservation survives on a preempted host, and no card
        #    is claimed twice anywhere (the re-slice was clean)
        claimed: Dict[tuple, str] = {}
        for reservation in scheduler.ledger.all():
            assert reservation.host_id not in report.preempted, (
                f"reservation {reservation.reservation_id} orphaned on "
                f"preempted host {reservation.host_id}: {describe}"
            )
            for chip in reservation.chip_ids:
                key = (reservation.host_id, chip)
                assert key not in claimed, (
                    f"card {key} double-reserved: {describe}"
                )
                claimed[key] = reservation.reservation_id

        # 2. exactly ONE gang incarnation is running: every stored
        #    gang task's CURRENT id is alive on the agent, and no id
        #    from any older gang launch survives anywhere
        active = scheduler.agent.active_task_ids()
        current_ids = set()
        for name in self._gang_task_names(scheduler):
            info = scheduler.state_store.fetch_task(name)
            if info is None:
                continue  # elastically trimmed
            current_ids.add(info.task_id)
            assert info.task_id in active, (
                f"{name} has no live process: {describe}"
            )
            assert info.agent_id not in report.preempted, (
                f"{name} placed on preempted host {info.agent_id}: "
                f"{describe}"
            )
        stale = {
            launched.task_id
            for launched in self.agent.launched
            if launched.pod_type == self.gang_pod
            and launched.task_id not in current_ids
        }
        assert not (stale & active), (
            f"zombie gang incarnation still running: "
            f"{sorted(stale & active)}: {describe}"
        )

        # 3. fabric locality held: a single-slice gang landed in ONE
        #    fabric (find_node_set's contract; trivially true for the
        #    elastic-shrunk gang too)
        slices = {
            scheduler.inventory.host(h).slice_id
            for h in set(report.final_hosts.values())
            if scheduler.inventory.host(h) is not None
        }
        pod = scheduler.spec.pod(self.gang_pod)
        if pod.gpu is not None and pod.gpu.topology and pod.gpu.slices == 1:
            gang_hosts = {
                host for name, host in report.final_hosts.items()
                if name.startswith(f"{self.gang_pod}-")
            }
            gang_slices = {
                scheduler.inventory.host(h).slice_id
                for h in gang_hosts
                if scheduler.inventory.host(h) is not None
            }
            assert len(gang_slices) <= 1, (
                f"gang split across slices {sorted(gang_slices)}: "
                f"{describe}"
            )
        elif pod.gpu is not None and pod.gpu.slices > 1:
            # multi-slice convergence: the surviving gang
            # is either the FULL dcn span re-placed or a whole-slice
            # shrink of it — each surviving sub-slice is complete
            # (hosts-per-slice workers, one slice each), no worker
            # sits on a dead slice, and the stored width is a clean
            # slice multiple (the dp x dcn batch axes resharded
            # evenly; a ragged width would mean a torn sub-gang)
            hps = max(1, pod.count // pod.gpu.slices)
            by_slice: Dict[str, int] = {}
            stored = 0
            for name, host in report.final_hosts.items():
                if not name.startswith(f"{self.gang_pod}-"):
                    continue
                if scheduler.state_store.fetch_task(name) is None:
                    continue  # trimmed by the whole-slice shrink
                stored += 1
                h = scheduler.inventory.host(host)
                assert h is not None, (
                    f"{name} on unknown host {host}: {describe}"
                )
                by_slice[h.slice_id] = by_slice.get(h.slice_id, 0) + 1
            assert stored and stored % hps == 0 and stored <= pod.count, (
                f"gang width {stored} is not a whole-slice multiple of "
                f"{hps} (full {pod.count}): {describe}"
            )
            assert len(by_slice) == stored // hps and \
                all(n == hps for n in by_slice.values()), (
                    f"torn sub-slice layout {by_slice} for width "
                    f"{stored}: {describe}"
                )
        del slices

        # 4. the WAL/status consistency the chaos harness promises
        for info in scheduler.state_store.fetch_tasks():
            status = scheduler.state_store.fetch_status(info.name)
            assert status is not None and \
                status.task_id == info.task_id, (
                    f"task {info.name} has no status for its launch: "
                    f"{describe}"
                )

    def shutdown(self) -> None:
        self.harness.shutdown()


class ChaosMatrix:
    """The full kill matrix: every kind x a set of occurrences, run
    order shuffled by ``seed`` (recorded in every report so failures
    replay: CHAOS_SEED=<seed> reruns the identical schedule)."""

    def __init__(self, occurrences: Tuple[int, ...] = (1, 2),
                 seed: int = 0):
        self.seed = seed
        schedule = [
            KillPoint(kind, occurrence)
            for kind in CHAOS_KINDS
            for occurrence in occurrences
        ]
        random.Random(seed).shuffle(schedule)
        self.schedule = schedule

    def run(self, harness_factory, timeout_s: float = 60.0) -> List[ChaosReport]:
        """``harness_factory(seed) -> ChaosHarness`` builds a FRESH
        world per kill point (kills must not compound)."""
        reports = []
        for point in self.schedule:
            harness = harness_factory(self.seed)
            try:
                reports.append(harness.run(point, timeout_s=timeout_s))
            finally:
                harness.shutdown()
        return reports


# -- auto-derived chaos points (durcheck persistence-point map) -------

# the point kinds a persister-level crash proxy can actually observe:
# everything that crosses the persister write API.  Journal appends
# are buffered record writes (the flush's store_property is the
# durability boundary), checkpoints ride a store_property too, and
# file writes bypass the persister entirely — excluding them keeps
# statically-unprobeable kinds out of the probe set, so 'unreached'
# means "this persister boundary was not exercised", never "this kind
# is invisible by construction".
AUTO_CHAOS_KINDS = ("wal", "store", "property", "persister", "delete")


def point_key(point: Dict[str, object]) -> Tuple[str, int, str]:
    """Stable identity of a persistence point across runs."""
    return (str(point["file"]), int(point["line"]), str(point["kind"]))


def auto_chaos_points(root: Optional[str] = None) -> List[Dict[str, object]]:
    """The statically discovered crash-injection candidates: the
    durcheck persistence-point map filtered to persister-crossing
    kinds (cached in durcheck, so every harness in a session shares
    one AST pass)."""
    from dcos_commons_tpu_torch.analysis.durcheck import persistence_point_map

    return [
        point for point in persistence_point_map(root)
        if point["kind"] in AUTO_CHAOS_KINDS
    ]


class PersisterCrashProxy:
    """Wraps the harness persister; every mutation is stack-matched
    against the persistence-point map.  Each matching frame marks
    that point covered (one ``store.store_launch`` call covers both
    the state-store apply site and the scheduler's recorder line —
    every boundary on the stack IS at its crash window).  When the
    designated ``target`` point appears on the stack for the
    ``occurrence``-th time, the proxy raises ``SchedulerKilled``
    BEFORE delegating — crash-before-mutation, the maximal window
    ``dur-effect-before-wal`` reasons about — then disarms so the
    successor converges.  Reads delegate untouched."""

    _MUTATORS = ("set", "apply", "recursive_delete", "clear_all_data")

    def __init__(
        self,
        inner,
        points: List[Dict[str, object]],
        target: Optional[Dict[str, object]] = None,
        occurrence: int = 1,
    ):
        self._inner = inner
        self._points = points
        self.target = target
        self._target_key = point_key(target) if target else None
        self._occurrence = occurrence
        self._hits = 0
        self.fired = False
        self.covered: Set[Tuple[str, int, str]] = set()

    def _observe(self) -> None:
        on_target = False
        frame = sys._getframe(2)
        while frame is not None:
            fname = frame.f_code.co_filename.replace(os.sep, "/")
            lineno = frame.f_lineno
            for point in self._points:
                if fname.endswith(str(point["file"])) and \
                        int(point["line"]) <= lineno <= \
                        int(point["end_line"]):
                    key = point_key(point)
                    self.covered.add(key)
                    if key == self._target_key:
                        on_target = True
            frame = frame.f_back
        if on_target and not self.fired:
            self._hits += 1
            if self._hits >= self._occurrence:
                self.fired = True
                target = self.target
                raise SchedulerKilled(
                    f"auto:{target['file']}:{target['line']}"
                    f":{target['kind']}",
                    self._hits,
                )

    def set(self, *args, **kwargs):
        self._observe()
        return self._inner.set(*args, **kwargs)

    def apply(self, *args, **kwargs):
        self._observe()
        return self._inner.apply(*args, **kwargs)

    def recursive_delete(self, *args, **kwargs):
        self._observe()
        return self._inner.recursive_delete(*args, **kwargs)

    def clear_all_data(self, *args, **kwargs):
        self._observe()
        return self._inner.clear_all_data(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._inner, name)


@dataclass
class BoundaryReport:
    """One auto-derived boundary run: the targeted point (None for
    the coverage probe), the underlying kill-and-converge report, and
    the unWAL'd effects observed at the moment of death."""

    point: Optional[Dict[str, object]]
    report: ChaosReport
    unwald_at_death: List[str] = field(default_factory=list)


@dataclass
class AutoChaosResult:
    """The auto-derived matrix outcome.  ``unreached`` is DATA, not a
    skip: every statically discovered boundary the harness could not
    cross is accounted here, and the integration test pins the set —
    a new unreachable boundary is a finding someone must explain."""

    seed: int
    all_points: List[Dict[str, object]] = field(default_factory=list)
    reached: List[Dict[str, object]] = field(default_factory=list)
    unreached: List[Dict[str, object]] = field(default_factory=list)
    targeted: List[Dict[str, object]] = field(default_factory=list)
    reports: List[BoundaryReport] = field(default_factory=list)

    def describe(self) -> str:
        return (
            f"auto-chaos[seed={self.seed} "
            f"points={len(self.all_points)} "
            f"reached={len(self.reached)} "
            f"unreached={len(self.unreached)} "
            f"crashed={len(self.reports)}]"
        )


class AutoChaosMatrix:
    """The statically derived kill matrix: one uninjected coverage
    probe separates reachable boundaries from unreachable ones, then
    a seed-shuffled budgeted subset of the REACHED points each get a
    fresh-world crash run (CI budget discipline: the full reached set
    is usually larger than one tier can afford; the seed is recorded
    so a failing subset replays exactly)."""

    def __init__(
        self,
        seed: int = 0,
        budget: int = 6,
        root: Optional[str] = None,
    ):
        self.seed = seed
        self.budget = budget
        self.points = auto_chaos_points(root)

    def run(self, harness_factory,
            timeout_s: float = 60.0) -> AutoChaosResult:
        """``harness_factory(seed) -> ChaosHarness`` builds a FRESH
        world per boundary, exactly like ``ChaosMatrix.run``."""
        result = AutoChaosResult(seed=self.seed, all_points=self.points)
        # 1. coverage probe: healthy run, no injection — which of the
        #    statically discovered boundaries does this world cross?
        harness = harness_factory(self.seed)
        probe = PersisterCrashProxy(harness.persister, self.points)
        harness.persister = probe
        try:
            harness.run_boundary(probe, timeout_s=timeout_s)
        finally:
            harness.shutdown()
        reached_keys = set(probe.covered)
        result.reached = [
            p for p in self.points if point_key(p) in reached_keys
        ]
        result.unreached = [
            p for p in self.points if point_key(p) not in reached_keys
        ]
        # 2. seeded budgeted subset of reached boundaries: crash runs
        targeted = list(result.reached)
        random.Random(self.seed).shuffle(targeted)
        result.targeted = targeted[: self.budget]
        for point in result.targeted:
            harness = harness_factory(self.seed)
            proxy = PersisterCrashProxy(
                harness.persister, self.points, target=point
            )
            harness.persister = proxy
            try:
                result.reports.append(
                    harness.run_boundary(proxy, timeout_s=timeout_s)
                )
            finally:
                harness.shutdown()
        return result
