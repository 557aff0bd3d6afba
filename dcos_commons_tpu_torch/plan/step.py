"""Steps: the leaves of the plan tree that actually launch pods.

Reference: scheduler/plan/Step.java:15, DeploymentStep.java:122-193
(TaskStatus -> step status mapping incl. readiness gating and DELAYED
backoff), PodInstanceRequirement.java, recovery/RecoveryType.java:7-25.

TPU-first: a step covers a whole pod *instance* as in the reference,
but for ``gang: true`` pods the step factory emits one step per pod
covering ALL instances (a gang's process group launches and fails
as a unit —
SURVEY.md section 7 hard part 3).

Port of ``dcos_commons_tpu/plan/step.py``,
line for line but the imports.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from dcos_commons_tpu_torch.common import TaskState, TaskStatus, task_name_of
from dcos_commons_tpu_torch.plan.backoff import Backoff, DisabledBackoff
from dcos_commons_tpu_torch.plan.element import Element
from dcos_commons_tpu_torch.plan.status import Status
from dcos_commons_tpu_torch.specification.specs import GoalState, PodSpec, task_full_name


class RecoveryType(enum.Enum):
    """Reference: recovery/RecoveryType.java:7-25."""

    NONE = "NONE"
    TRANSIENT = "TRANSIENT"    # relaunch in place, keep reservations
    PERMANENT = "PERMANENT"    # destroy + replace elsewhere


@dataclass
class PodInstanceRequirement:
    """What a step asks the offer evaluator for.

    Reference: plan/PodInstanceRequirement.java — pod instance +
    tasks-to-launch + recovery type.  ``instances`` is a list to
    support gang pods (all instances evaluated/launched together).
    """

    pod: PodSpec
    instances: List[int]
    tasks_to_launch: List[str] = field(default_factory=list)
    recovery_type: RecoveryType = RecoveryType.NONE
    # operator-supplied env merged into every launched task, set by a
    # parameterized `plan start` (reference: PlansQueries.java:47-231
    # start-with-env — what makes cassandra's backup/restore sidecar
    # plans operable: snapshot name, external location)
    env_overrides: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.tasks_to_launch:
            self.tasks_to_launch = [t.name for t in self.pod.tasks]

    @property
    def asset_names(self) -> Set[str]:
        """Pod-instance names this requirement touches — the "dirty
        assets" the coordinator uses for mutual exclusion
        (DefaultPlanCoordinator.java:33-90)."""
        return {f"{self.pod.type}-{i}" for i in self.instances}

    def task_names(self) -> List[str]:
        return [
            task_full_name(self.pod.type, i, t)
            for i in self.instances
            for t in self.tasks_to_launch
        ]

    @property
    def name(self) -> str:
        idx = ",".join(str(i) for i in self.instances)
        return f"{self.pod.type}-[{idx}]:[{','.join(self.tasks_to_launch)}]"


class Step(Element):
    """Reference: plan/Step.java:15."""

    # traceview hook: callable(step, old_status, new_status, status)
    # invoked on every state transition; ``status`` is the triggering
    # TaskStatus (None for launch-time and operator-verb transitions).
    # Wired by the scheduler via PlanManager.set_transition_listener —
    # steps never import the tracer, keeping the plan layer inert when
    # tracing is disabled.
    transition_listener = None

    def _notify_transition(self, old: Status, new: Status,
                           status: Optional[TaskStatus] = None) -> None:
        listener = self.transition_listener
        if listener is None or old is new:
            return
        try:
            listener(self, old, new, status)
        except Exception:
            # a broken trace listener must never wedge the plan machine
            import logging

            logging.getLogger(__name__).exception(
                "step transition listener failed for %s", self.name
            )

    def start(self) -> Optional[PodInstanceRequirement]:
        """Called when this step is a candidate; returns the work."""
        raise NotImplementedError

    def update_offer_status(self, launched: bool) -> None:
        """Outcome of offer evaluation for this step's requirement."""
        raise NotImplementedError

    def update(self, status: TaskStatus) -> None:
        """Route a TaskStatus belonging to this step."""
        raise NotImplementedError

    def get_asset_names(self) -> Set[str]:
        return set()


class ActionStep(Step):
    """A scheduler-side action instead of a pod launch.

    Reference: the uninstall/decommission step families —
    scheduler/uninstall/ResourceCleanupStep.java, DeregisterStep.java,
    scheduler/decommission/TriggerDecommissionStep.java,
    EraseTaskStateStep.java — steps whose work is performed by the
    scheduler itself against its stores/agent.  ``action(scheduler)``
    returns True when the work is done; False keeps the step pending
    for the next cycle (e.g. waiting for kill acknowledgements).
    """

    def __init__(self, name: str, action, assets=None):
        super().__init__(name)
        self._action = action
        self._assets = set(assets or ())
        self._status = Status.PENDING
        self._interrupted = False

    def start(self) -> Optional[PodInstanceRequirement]:
        return None  # nothing for the offer evaluator

    def execute(self, scheduler) -> None:
        with self._lock:
            if self._status.is_complete or self._interrupted:
                return
            try:
                done = self._action(scheduler)
            except Exception as e:
                # transient failures retry next cycle: replace (don't
                # accumulate) the error, and let a later success clear
                # it so the step isn't wedged at ERROR forever
                self.errors[:] = [f"{self.name}: {e}"]
                return
            self.errors.clear()
            old = self._status
            self._status = Status.COMPLETE if done else Status.PENDING
            self._notify_transition(old, self._status)

    def update_offer_status(self, launched: bool) -> None:
        pass

    def update(self, status: TaskStatus) -> None:
        pass  # progress is re-checked by execute() each cycle

    def get_status(self) -> Status:
        with self._lock:
            if self.has_errors():
                return Status.ERROR
            if self._interrupted and not self._status.is_complete:
                return Status.WAITING
            return self._status

    def interrupt(self) -> None:
        with self._lock:
            self._interrupted = True

    def proceed(self) -> None:
        with self._lock:
            self._interrupted = False

    def is_interrupted(self) -> bool:
        return self._interrupted

    def restart(self) -> None:
        with self._lock:
            self._status = Status.PENDING
            self.errors.clear()

    def force_complete(self) -> None:
        with self._lock:
            self._status = Status.COMPLETE
            self.errors.clear()

    def get_asset_names(self) -> Set[str]:
        return set(self._assets)


class DeploymentStep(Step):
    """Launch one pod instance (or one gang) and drive it to goal.

    Reference: plan/DeploymentStep.java — specifically the status
    mapping at :122-193: launch recorded -> STARTING; TASK_RUNNING ->
    STARTED, then COMPLETE once readiness passes (or immediately if no
    readiness check); TASK_FINISHED -> COMPLETE for FINISH/ONCE goals;
    failures -> PENDING, or DELAYED under launch backoff.
    """

    def __init__(
        self,
        name: str,
        requirement: PodInstanceRequirement,
        backoff: Optional[Backoff] = None,
    ):
        super().__init__(name)
        self.requirement = requirement
        self._status = Status.PENDING
        self._interrupted = False
        self._backoff = backoff or DisabledBackoff()
        self._delay_until = 0.0
        # task full-name -> expected task id (set at launch record time)
        self._expected: Dict[str, str] = {}
        # task full-name -> last seen state
        self._task_states: Dict[str, TaskState] = {}
        self._task_ready: Dict[str, bool] = {}
        # exact full-name -> TaskSpec map (suffix matching would confuse
        # task names that are dash-suffixes of each other)
        self._spec_by_full = {
            task_full_name(requirement.pod.type, i, spec.name): spec
            for i in requirement.instances
            for spec in requirement.pod.tasks
            if spec.name in requirement.tasks_to_launch
        }

    # -- candidate lifecycle -----------------------------------------

    def start(self) -> Optional[PodInstanceRequirement]:
        with self._lock:
            if self._interrupted or self.has_errors():
                return None
            if self._status is Status.DELAYED:
                if time.monotonic() < self._delay_until:
                    return None
                self._status = Status.PENDING
            if self._status is Status.PENDING:
                return self.requirement
            return None

    def record_launch(self, task_ids: Dict[str, str]) -> None:
        """Called after the launch WAL: map task name -> task id."""
        with self._lock:
            self._expected = dict(task_ids)
            self._task_states = {}
            self._task_ready = {}
            old = self._status
            self._status = Status.STARTING
            self._notify_transition(old, self._status)

    def update_offer_status(self, launched: bool) -> None:
        with self._lock:
            if launched:
                # record_launch carries the ids; nothing more here
                return
            # no inventory matched: stay PENDING; the outcome tracker
            # explains why (debug/OfferOutcomeTracker)

    # -- status intake -----------------------------------------------

    def update(self, status: TaskStatus) -> None:
        with self._lock:
            try:
                name = task_name_of(status.task_id)
            except ValueError:
                return
            if name not in self._expected:
                return
            if self._expected[name] and status.task_id != self._expected[name]:
                return  # stale status from an older launch
            if self._status.is_complete:
                # a completed deploy step never regresses: post-deploy
                # failures belong to the recovery plan (reference:
                # DeploymentStep stays COMPLETE; recovery manager owns
                # keep-alive, DefaultRecoveryPlanManager.java:164)
                return
            if status.state is TaskState.ERROR:
                # NON-recoverable: provisioning failed before the
                # command ever ran (missing template/artifact, bad
                # secret) — a retry fails identically, so surface as
                # plan ERROR instead of crash-looping (reference:
                # TASK_ERROR -> step ERROR, DeploymentStep.java:163-193;
                # exits are `plan restart`/forceComplete or a config
                # fix rolling a new target)
                # accumulate per task (a gang can have SEVERAL distinct
                # provisioning failures; hiding all but the last costs
                # the operator one full rollout per hidden error)
                had_errors = self.has_errors()
                message = f"{name}: {status.message or 'task ERROR'}"
                self.errors[:] = [
                    e for e in self.errors
                    if not e.startswith(f"{name}: ")
                ] + [message]
                self._task_states[name] = status.state
                if not had_errors:
                    self._notify_transition(
                        self._status, Status.ERROR, status
                    )
                return
            old = self._status
            self._task_states[name] = status.state
            if status.ready:
                self._task_ready[name] = True
            self._recompute(failed=status.state.is_failure)
            self._notify_transition(old, self._status, status)

    def _goal_of(self, task_full: str) -> GoalState:
        spec = self._spec_by_full.get(task_full)
        return spec.goal if spec is not None else GoalState.RUNNING

    def _needs_readiness(self, task_full: str) -> bool:
        spec = self._spec_by_full.get(task_full)
        return spec is not None and spec.readiness_check is not None

    def _task_done(self, task_full: str) -> bool:
        state = self._task_states.get(task_full)
        if state is None:
            return False
        goal = self._goal_of(task_full)
        if goal in (GoalState.FINISH, GoalState.ONCE):
            return state is TaskState.FINISHED
        if state is TaskState.RUNNING:
            return (not self._needs_readiness(task_full)) or self._task_ready.get(
                task_full, False
            )
        return False

    def _recompute(self, failed: bool) -> None:
        expected = list(self._expected)
        if failed:
            # any failure in the gang resets the whole step: a pjit pod
            # cannot run degraded (gang semantics; for non-gang pods the
            # step covers a single instance anyway).  The aborted
            # launch's state is dropped so a re-delivered status from it
            # cannot lift the step out of PENDING/DELAYED.
            self._expected = {}
            self._task_states = {}
            self._task_ready = {}
            delay = self._backoff.next_delay(self.name)
            if delay > 0:
                self._delay_until = time.monotonic() + delay
                self._status = Status.DELAYED
            else:
                self._status = Status.PENDING
            return
        if expected and all(self._task_done(t) for t in expected):
            self._backoff.clear(self.name)
            self._status = Status.COMPLETE
        elif any(
            self._task_states.get(t) is TaskState.RUNNING for t in expected
        ):
            self._status = Status.STARTED
        # else remain STARTING

    # -- Element -----------------------------------------------------

    def get_status(self) -> Status:
        with self._lock:
            if self.has_errors():
                return Status.ERROR
            if self._interrupted and not self._status.is_complete:
                return Status.WAITING
            if self._status is Status.DELAYED and \
                    time.monotonic() >= self._delay_until:
                return Status.PENDING
            return self._status

    def get_raw_status(self) -> Status:
        return self._status

    def interrupt(self) -> None:
        with self._lock:
            self._interrupted = True

    def proceed(self) -> None:
        with self._lock:
            self._interrupted = False

    def is_interrupted(self) -> bool:
        return self._interrupted

    def restart(self) -> None:
        """Reference: PlansQueries restart verb — back to PENDING.
        Clears recorded ERRORs: restart is one of the operator's two
        exits from a non-recoverable step."""
        with self._lock:
            old = self._status
            self._status = Status.PENDING
            self._expected = {}
            self._task_states = {}
            self._task_ready = {}
            self._delay_until = 0.0
            self.errors.clear()
            self._notify_transition(old, self._status)

    def force_complete(self) -> None:
        with self._lock:
            old = self._status
            self._status = Status.COMPLETE
            self.errors.clear()
            self._notify_transition(old, self._status)

    def get_asset_names(self) -> Set[str]:
        return self.requirement.asset_names

    def expected_task_ids(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._expected)
