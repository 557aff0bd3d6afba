"""DefaultRecoveryPlanManager: synthesize recovery steps from failures.

Reference: recovery/DefaultRecoveryPlanManager.java — updatePlan
(:164) scans the state store for failed tasks each status update and
appends recovery steps for pods not already being recovered; the
FailureMonitor decides TRANSIENT (relaunch in place, reservations
kept) vs PERMANENT (destroy + replace, :378-420); per-service
RecoveryPlanOverriders may replace the default steps with a custom
phase (Cassandra seed-replace choreography is the reference example).

Port of ``dcos_commons_tpu/recovery/manager.py``, line for line but
the imports and ``pod.gpu`` for ``pod.tpu``.  A host's ``slice_id`` is
its NVLink fabric (offer/inventory.py), so the regrow check counts
fully-up hosts of the pod's generation per fabric.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Set

from dcos_commons_tpu_torch.common import Label, TaskState, TaskStatus
from dcos_commons_tpu_torch.plan.backoff import Backoff
from dcos_commons_tpu_torch.plan.phase import Phase
from dcos_commons_tpu_torch.plan.plan import RECOVERY_PLAN_NAME, Plan
from dcos_commons_tpu_torch.plan.plan_manager import PlanManager
from dcos_commons_tpu_torch.plan.step import (
    ActionStep,
    DeploymentStep,
    PodInstanceRequirement,
    RecoveryType,
    Step,
)
from dcos_commons_tpu_torch.plan.strategy import ParallelStrategy, SerialStrategy
from dcos_commons_tpu_torch.recovery.elastic import ElasticGangStep, ElasticPolicy
from dcos_commons_tpu_torch.recovery.monitor import FailureMonitor, NeverFailureMonitor
from dcos_commons_tpu_torch.specification.specs import (
    GoalState,
    ServiceSpec,
    pod_instance_name,
    task_full_name,
)
from dcos_commons_tpu_torch.state.state_store import StateStore

# A RecoveryPlanOverrider may return a replacement Phase for a failed
# pod instance (reference: RecoveryPlanOverrider(Factory)); return
# None to keep the default single-step recovery.
RecoveryPlanOverrider = Callable[
    [str, List[int], RecoveryType], Optional[Phase]
]


class DefaultRecoveryPlanManager(PlanManager):
    def __init__(
        self,
        spec: ServiceSpec,
        state_store: StateStore,
        failure_monitor: Optional[FailureMonitor] = None,
        backoff: Optional[Backoff] = None,
        overriders: Optional[List[RecoveryPlanOverrider]] = None,
        externally_managed: Optional[Callable[[str], bool]] = None,
    ):
        self._spec = spec
        self._state_store = state_store
        self._monitor = failure_monitor or NeverFailureMonitor()
        self._backoff = backoff
        self._overriders = list(overriders or [])
        # pods with incomplete work in another plan (deploy/update) are
        # that plan's responsibility — recovering them here would race
        # the rollout (reference: recovery defers to dirtied assets)
        self._externally_managed = externally_managed or (lambda _name: False)
        self._lock = threading.RLock()
        # active recovery elements keyed by pod instance name
        self._phases: Dict[str, Phase] = {}
        # keys whose phase came from a RecoveryPlanOverrider: custom
        # choreography is authoritative — never rebuilt/widened by the
        # default scoping logic
        self._custom_keys: Set[str] = set()
        self._plan = Plan(RECOVERY_PLAN_NAME, [], ParallelStrategy())
        # health-plane event journal (set by the owning scheduler):
        # every synthesized recovery phase is a "recovery" event, so
        # an operator can reconstruct WHEN a pod started recovering
        # long after the recovery plan pruned the completed phase
        self.journal = None
        # the shared fleet inventory (set by the builder): the gang
        # recovery phase's elastic step probes maintenance windows
        # through it to choose waiting over shrinking.  None (hand-
        # wired tests) means "no window ever promises capacity back".
        self.inventory = None

    def _journal_phase(self, key: str, recovery_type, rebuilt: bool) -> None:
        if self.journal is None:
            return
        self.journal.append(
            "recovery",
            pod=key,
            type=recovery_type.value
            if hasattr(recovery_type, "value") else str(recovery_type),
            rebuilt=rebuilt,
            message=f"recovery phase {'rebuilt' if rebuilt else 'created'} "
                    f"for {key}",
        )

    def set_spec(self, spec: ServiceSpec) -> None:
        with self._lock:
            self._spec = spec

    def add_externally_managed(self, predicate) -> None:
        """OR another owner into the externally-managed check: the
        scheduler registers the autoscale plan here so recovery never
        races an in-flight scale action for the same instance (a
        failed scale-out launch is the scale phase's to retry, like a
        failed deploy launch is the deploy plan's)."""
        with self._lock:
            prev = self._externally_managed
            self._externally_managed = (
                lambda name: prev(name) or predicate(name)
            )

    # -- PlanManager --------------------------------------------------

    def get_plan(self) -> Plan:
        with self._lock:
            self._prune_completed()
            self._plan.phases = list(self._phases.values())
            return self._plan

    def get_candidates(self, dirty_assets: Set[str]) -> List[Step]:
        with self._lock:
            self._refresh()
            return self.get_plan().candidates(dirty_assets)

    def update(self, status: TaskStatus) -> None:
        with self._lock:
            for phase in self._phases.values():
                phase.update(status)
            # plan synthesis happens once per cycle in get_candidates,
            # NOT per status: _refresh scans every pod's stored state,
            # and a fleet-scale status burst (100 pods reporting in one
            # intake) would turn that into an O(statuses x pods) sweep
            # with identical end-of-cycle behavior

    # -- plan synthesis ----------------------------------------------

    def _prune_completed(self) -> None:
        for key in [k for k, p in self._phases.items() if p.is_complete]:
            del self._phases[key]
            self._custom_keys.discard(key)

    def _refresh(self) -> None:
        """Reference: updatePlan (DefaultRecoveryPlanManager.java:164)."""
        self._prune_completed()
        failed = self._find_failed_pods()
        self._maybe_regrow(failed)
        for (pod_type, instances), (recovery_type, tasks) in failed.items():
            key = pod_instance_name(pod_type, instances[0])
            if any(
                self._externally_managed(pod_instance_name(pod_type, i))
                for i in instances
            ):
                continue
            if recovery_type is RecoveryType.PERMANENT:
                # PERMANENT is whole-pod destroy+replace: a subset of a
                # pod re-placed from scratch would split colocation
                # (fresh host, fresh volumes) from its live siblings.
                # "Whole pod" = its LAUNCHED footprint: launched FINISH
                # init tasks rerun on the fresh volumes, but sidecars
                # whose plan never ran must not be resurrected.
                tasks = self._launched_tasks(pod_type, instances)
            existing = self._phases.get(key)
            if existing is not None:
                if getattr(existing, "gang_recovery", False):
                    # the gang recovery phase IS the widest possible
                    # scope (kill all -> unreserve -> re-place whole
                    # gang, PERMANENT): nothing escalates past it, and
                    # its ActionSteps must never be "rebuilt" by the
                    # DeploymentStep-shaped widening logic below
                    continue
                if key in self._custom_keys:
                    # overrider choreography is authoritative: escalate
                    # its steps in place, never rebuild around it
                    if recovery_type is RecoveryType.PERMANENT:
                        for step in existing.steps:
                            if isinstance(step, DeploymentStep) and \
                                    step.requirement.recovery_type is \
                                    RecoveryType.TRANSIENT:
                                step.requirement.recovery_type = \
                                    RecoveryType.PERMANENT
                    continue
                covered = self._phase_tasks(existing)
                required = self._required_tasks(pod_type, instances, tasks)
                if recovery_type is RecoveryType.PERMANENT and not all(
                    isinstance(s, DeploymentStep)
                    and s.requirement.recovery_type is RecoveryType.PERMANENT
                    for s in existing.steps
                ):
                    # escalate by REBUILDING at the scoped task set —
                    # an in-place flip of a subset phase would
                    # permanently re-place only part of the pod, and a
                    # None (all-tasks) rebuild would resurrect
                    # completed FINISH tasks and never-launched
                    # sidecars the scoping in _find_failed_pods
                    # deliberately excludes.  The rebuild is a replace,
                    # so it counts against the rate limit.
                    phase = self._make_phase(
                        pod_type, list(instances), recovery_type, tasks
                    )
                    if phase is not None:
                        self._phases[key] = phase
                        self._record_replace(pod_type, instances)
                        self._journal_phase(key, recovery_type, True)
                elif covered is not None and not required <= covered:
                    # a wider failure (an essential task died) arrived
                    # while a subset phase was in flight: rebuild so the
                    # new casualties are not deferred behind it —
                    # again at the SCOPED task set
                    phase = self._make_phase(
                        pod_type, list(instances), recovery_type, tasks
                    )
                    if phase is not None:
                        self._phases[key] = phase
                        self._journal_phase(key, recovery_type, True)
                continue
            phase = self._make_phase(
                pod_type, list(instances), recovery_type, tasks
            )
            if phase is not None:
                self._phases[key] = phase
                if recovery_type is RecoveryType.PERMANENT:
                    self._record_replace(pod_type, instances)
                self._journal_phase(key, recovery_type, False)

    def _launched_tasks(
        self, pod_type: str, instances
    ) -> Optional[List[str]]:
        """Union of task names with stored TaskInfos across the
        instances; None when every spec task has launched (the
        all-tasks fast path)."""
        pod = self._spec.pod(pod_type)
        launched = set()
        for task_spec in pod.tasks:
            for index in instances:
                full = task_full_name(pod_type, index, task_spec.name)
                if self._state_store.fetch_task(full) is not None:
                    launched.add(task_spec.name)
                    break
        if len(launched) == len(pod.tasks):
            return None
        return sorted(launched)

    def _phase_tasks(self, phase: Phase) -> Optional[Set[str]]:
        """Full task names a recovery phase covers; None when the phase
        holds non-introspectable custom steps."""
        covered: Set[str] = set()
        for step in phase.steps:
            if not isinstance(step, DeploymentStep):
                return None
            covered |= set(step.requirement.task_names())
        return covered

    def _required_tasks(
        self, pod_type: str, instances, tasks: Optional[List[str]]
    ) -> Set[str]:
        pod = self._spec.pod(pod_type)
        names = tasks if tasks is not None else [
            t.name for t in pod.tasks
        ]
        return {
            task_full_name(pod_type, i, n)
            for i in instances
            for n in names
        }

    def _find_failed_pods(self) -> Dict[tuple, tuple]:
        """Scan stored statuses for tasks needing recovery, grouped by
        pod instance (whole pod for gang pods).

        Values are (recovery_type, tasks_to_launch or None).  Essential
        semantics (reference: TaskSpec.isEssential): an essential
        task's failure relaunches the whole pod instance; failures of
        ONLY non-essential tasks relaunch just those tasks, leaving
        their essential siblings running.
        """
        out: Dict[tuple, tuple] = {}
        for pod in self._spec.pods:
            gang_failed: Set[int] = set()
            gang_type = RecoveryType.TRANSIENT
            for index in range(pod.count):
                failed_tasks: Dict[str, RecoveryType] = {}
                essential_failed = False
                launched: Set[str] = set()
                for task_spec in pod.tasks:
                    full = task_full_name(pod.type, index, task_spec.name)
                    info = self._state_store.fetch_task(full)
                    status = self._state_store.fetch_status(full)
                    if info is not None:
                        launched.add(task_spec.name)
                    if info is None or status is None:
                        continue
                    needs, rtype = self._needs_recovery(
                        full, info, status, task_spec.goal,
                        pod_instance_name(pod.type, index),
                    )
                    if not needs:
                        continue
                    failed_tasks[task_spec.name] = rtype
                    essential_failed |= task_spec.essential
                if not failed_tasks:
                    continue
                rtype = (
                    RecoveryType.PERMANENT
                    if RecoveryType.PERMANENT in failed_tasks.values()
                    else RecoveryType.TRANSIENT
                )
                if pod.gang:
                    gang_failed.add(index)
                    if rtype is RecoveryType.PERMANENT:
                        gang_type = RecoveryType.PERMANENT
                elif essential_failed:
                    # "whole pod" = the instance's LAUNCHED footprint:
                    # the failed tasks plus running-goal siblings.
                    # Tasks that never launched (sidecars whose plan
                    # hasn't run) and FINISH/ONCE tasks that already
                    # completed must NOT (re)run — pods whose replace
                    # needs init choreography use a RecoveryPlanOverrider
                    # (reference: DefaultRecoveryPlanManager recovering
                    # stored tasks; HDFS/Cassandra overriders exist
                    # precisely because default recovery does not rerun
                    # bootstrap/format).
                    relaunch = []
                    for task_spec in pod.tasks:
                        if task_spec.name not in launched:
                            continue  # never launched
                        if task_spec.name in failed_tasks or \
                                task_spec.goal is GoalState.RUNNING:
                            relaunch.append(task_spec.name)
                    out[(pod.type, (index,))] = (rtype, sorted(relaunch))
                else:
                    out[(pod.type, (index,))] = (
                        rtype, sorted(failed_tasks)
                    )
            if pod.gang and gang_failed:
                # one worker down takes the whole slice through recovery
                out[(pod.type, tuple(range(pod.count)))] = (gang_type, None)
        return out

    # -- min replace delay (reference: ReplacementFailurePolicy
    #    minReplaceDelay — successive PERMANENT replaces of one pod
    #    instance are rate limited) --------------------------------

    def _record_replace(self, pod_type: str, instances) -> None:
        """Stamp EVERY replaced instance (a gang replace covers all of
        them — rate limiting keyed to instance 0 alone would let
        failures seen on other workers bypass the delay)."""
        now = str(time.time()).encode()
        for index in instances:
            self._state_store.store_property(
                f"last-replace-{pod_instance_name(pod_type, index)}", now
            )

    def _replace_delay_elapsed(self, pod_instance: str) -> bool:
        policy = self._spec.replacement_failure_policy
        if policy is None or policy.min_replace_delay_s <= 0:
            return True
        raw = self._state_store.fetch_property(
            f"last-replace-{pod_instance}"
        )
        if raw is None:
            return True
        try:
            last = float(raw.decode())
        except ValueError:
            return True
        return time.time() - last >= policy.min_replace_delay_s

    def _needs_recovery(self, full, info, status, goal, pod_instance):
        if info.labels.get(Label.PERMANENTLY_FAILED):
            # explicit operator intent (pod replace) or an already-
            # stamped escalation: the replace delay never blocks these
            return True, RecoveryType.PERMANENT
        if not status.state.is_terminal:
            self._monitor.clear(full)
            return False, RecoveryType.NONE
        # a terminal state satisfying the goal is success, not failure:
        # FINISHED satisfies FINISH/ONCE; nothing terminal satisfies
        # RUNNING (even exit 0 means the server died — relaunch it)
        if goal in (GoalState.FINISH, GoalState.ONCE) and \
                status.state is TaskState.FINISHED:
            return False, RecoveryType.NONE
        if self._monitor.has_failed_permanently(full, status):
            if not self._replace_delay_elapsed(pod_instance):
                # monitor says replace, but the last replace of this
                # instance was too recent: stay TRANSIENT for now
                # (reference: minReplaceDelay)
                return True, RecoveryType.TRANSIENT
            # stamp the label so the escalation survives restart
            self._state_store.store_tasks(
                [info.with_label(Label.PERMANENTLY_FAILED, "true")]
            )
            return True, RecoveryType.PERMANENT
        return True, RecoveryType.TRANSIENT

    def _make_phase(
        self,
        pod_type: str,
        instances: List[int],
        recovery_type: RecoveryType,
        tasks: Optional[List[str]] = None,
    ) -> Optional[Phase]:
        key = pod_instance_name(pod_type, instances[0])
        for overrider in self._overriders:
            phase = overrider(pod_type, instances, recovery_type)
            if phase is not None:
                self._custom_keys.add(key)
                return phase
        self._custom_keys.discard(key)
        pod = self._spec.pod(pod_type)
        if recovery_type is RecoveryType.PERMANENT and pod.gang and \
                len(instances) > 1:
            # whole-gang PERMANENT loss (preemption, operator replace,
            # monitor escalation): a pile of per-task relaunches would
            # leave survivors wedged in a dead collective and the
            # broken sub-slice reserved — synthesize the plan-driven
            # choreography instead
            return self._make_gang_phase(pod, instances, tasks)
        requirement = PodInstanceRequirement(
            pod=pod, instances=instances, recovery_type=recovery_type,
            tasks_to_launch=tasks,
        )
        name = f"recover-{pod_instance_name(pod_type, instances[0])}" if len(
            instances
        ) == 1 else f"recover-{pod_type}-gang"
        step = DeploymentStep(name, requirement, backoff=self._backoff)
        return Phase(name, [step], ParallelStrategy())

    # -- whole-slice regrow --------------------------------

    def _maybe_regrow(self, failed: Dict[tuple, tuple]) -> None:
        """Regrow a multi-slice elastic gang to its declared width.

        After a whole-slice elastic shrink the gang trains healthily
        at fewer slices — nothing is FAILED, so the failure scan will
        never touch it again.  This scan watches for exactly that
        state (a clean shrunken prefix of RUNNING instances) and,
        once the fleet again holds enough fully-up slices, synthesizes
        the SAME gang choreography at declared width: kill the
        shrunken incarnation, unreserve, re-place all slices, trim.
        The fenced-checkpoint restore re-lays the dcn axis back up
        exactly as the shrink laid it down.

        Rate-limited by the replacement-failure policy's
        min-replace-delay (a regrow IS a replace) and journaled as
        verb=elastic-regrow.  Scoped to multi-slice gangs: a
        single-slice elastic shrink changes the per-slice topology,
        and regrowing it is the update plan's `pod replace` path.
        """
        if self.inventory is None:
            return
        failed_types = {pt for (pt, _i) in failed}
        for pod in self._spec.pods:
            if not (
                pod.gang and pod.gpu is not None and pod.gpu.elastic
                and pod.gpu.slices > 1
            ):
                continue
            if pod.type in failed_types:
                continue  # active failure: the gang phase owns it
            key = pod_instance_name(pod.type, 0)
            if key in self._phases:
                continue
            if any(
                self._externally_managed(pod_instance_name(pod.type, i))
                for i in range(pod.count)
            ):
                continue
            width = self._running_width(pod)
            if width is None:
                continue
            if not self._replace_delay_elapsed(key):
                continue
            if not self._regrow_capacity(pod):
                continue
            instances = list(range(pod.count))
            phase = self._make_gang_phase(pod, instances, None)
            self._phases[key] = phase
            self._record_replace(pod.type, instances)
            if self.journal is not None:
                self.journal.append(
                    "recovery", pod=pod.type, verb="elastic-regrow",
                    hosts=pod.count, width=width,
                    message=(
                        f"regrowing {pod.type} from {width} to "
                        f"{pod.count} host(s): capacity returned"
                    ),
                )

    def _running_width(self, pod) -> Optional[int]:
        """The width of a HEALTHY shrunken gang: instances 0..w-1 have
        stored tasks whose latest status satisfies their goal, and
        instances w.. have none (the trim step's clean prefix).  None
        for anything else — full width, holes, or any unhealthy task
        (those are the failure scan's business, not regrow's)."""
        width = 0
        for index in range(pod.count):
            present = False
            for task_spec in pod.tasks:
                full = task_full_name(pod.type, index, task_spec.name)
                info = self._state_store.fetch_task(full)
                if info is None:
                    continue
                present = True
                status = self._state_store.fetch_status(full)
                if status is None or status.task_id != info.task_id:
                    return None
                if task_spec.goal in (GoalState.FINISH, GoalState.ONCE):
                    if status.state is not TaskState.FINISHED:
                        return None
                elif status.state is not TaskState.RUNNING:
                    return None
            if present:
                if index != width:
                    return None  # hole: not a clean shrunken prefix
                width += 1
        return width if 0 < width < pod.count else None

    def _regrow_capacity(self, pod) -> bool:
        """True when the fleet holds enough fully-up matching slices
        to place the gang at declared width.  The shrunken gang's own
        slices COUNT — the regrow choreography unreserves them before
        re-placing.  Other services' claims are not visible here, so
        this over-approximates; a regrow that then cannot place
        re-shrinks through the same decision rule and converges back.
        """
        hps = max(1, pod.count // max(1, pod.gpu.slices))
        by_slice: Dict[str, int] = {}
        for host in self.inventory.hosts():
            if host.generation != pod.gpu.generation:
                continue
            if self.inventory.host_state(host.host_id) != "up":
                continue
            by_slice[host.slice_id] = by_slice.get(host.slice_id, 0) + 1
        full = sum(1 for n in by_slice.values() if n >= hps)
        return full >= pod.gpu.slices

    # -- gang-granular recovery ----------------------------

    def _maintenance_returning(self, pod) -> bool:
        """True while some drained host's FINITE maintenance window
        (still in the future) could actually restore a full-size
        placement for ``pod`` — the elastic rule then waits instead
        of shrinking through it.

        Scoped to slices that could hold the gang: a window on an
        unrelated slice too small for the gang must NOT suppress the
        shrink (on a fleet doing routine rolling maintenance, some
        host always has a window somewhere — fleet-global waiting
        would disable elastic exactly at the scale it exists for).
        A slice qualifies when its hosts that are up-or-returning
        (up now, or draining with a finite future window) reach the
        gang's host count."""
        inventory = self.inventory
        if inventory is None or not hasattr(inventory, "maintenance_hosts"):
            return False
        now = time.time()
        returning = {
            h for h, end in inventory.maintenance_hosts().items()
            if end > now
        }
        if not returning:
            return False
        by_slice: Dict[str, List[str]] = {}
        for host in inventory.hosts():
            by_slice.setdefault(host.slice_id, []).append(host.host_id)
        need = pod.count
        for host_id in returning:
            host = inventory.host(host_id)
            if host is None:
                continue
            usable = [
                h for h in by_slice.get(host.slice_id, ())
                if h in returning or inventory.host_state(h) == "up"
            ]
            if len(usable) >= need:
                return True
        return False

    def _make_gang_phase(
        self,
        pod,
        instances: List[int],
        tasks: Optional[List[str]],
    ) -> Phase:
        """The gang recovery choreography, one serial phase:

            kill-survivors   a worker that lost a gang peer is wedged
                             in a dead collective — reap every live
                             member (tasks whose process no agent
                             reports count as already dead)
            unreserve-slice  release the broken footprint so the
                             re-placement may claim freed capacity
                             (incl. the survivors' own hosts)
            replace-gang     re-place the WHOLE gang PERMANENT,
                             on one NVLink fabric; shrinks to a
                             smaller mesh when the pod is elastic and
                             the decision rule allows
            trim-surplus     after an elastic shrink, erase the
                             surplus instances' task state so the
                             failure scan stops chasing ghosts

        Restart-safe by construction: every step is idempotent (a
        successor that re-runs kill/unreserve against an already-clean
        world completes them immediately) and the replace step's
        incarnation fencing (utils/checkpoint.py) makes any zombie
        survivor's late writes harmless.
        """
        names = sorted(self._required_tasks(pod.type, instances, tasks))
        assets = {pod_instance_name(pod.type, i) for i in instances}
        phase_name = f"recover-{pod.type}-gang"

        def kill_survivors(scheduler) -> bool:
            pending = False
            active = scheduler.agent.active_task_ids()
            for full in names:
                info = scheduler.state_store.fetch_task(full)
                if info is None:
                    continue
                status = scheduler.state_store.fetch_status(full)
                if status is not None and status.task_id == info.task_id \
                        and status.state.is_terminal:
                    continue
                if info.task_id not in active:
                    # no agent runs this process (preempted host, an
                    # already-reaped kill whose status was lost): dead
                    # in fact, even without a terminal status
                    continue
                scheduler.task_killer.kill(info.task_id)
                pending = True
            return not pending

        def unreserve_slice(scheduler) -> bool:
            released = 0
            for full in names:
                for res in list(scheduler.ledger.for_task(full)):
                    scheduler.ledger.release(res.reservation_id)
                    released += 1
            if released and scheduler.journal is not None:
                scheduler.journal.append(
                    "recovery", pod=pod.type, verb="unreserve",
                    reservations=released,
                    message=f"released {released} reservation(s) of the "
                            f"broken {pod.type} gang sub-slice",
                )
            return True

        policy = ElasticPolicy(
            enabled=bool(pod.gpu is not None and pod.gpu.elastic),
            min_hosts=pod.gpu.min_hosts if pod.gpu is not None else 1,
        )
        replace = ElasticGangStep(
            f"replace-{pod.type}-gang",
            pod,
            tasks,
            self._backoff,
            policy,
            maintenance_probe=lambda: self._maintenance_returning(pod),
            journal=self.journal,
        )

        def trim_surplus(scheduler) -> bool:
            erased = 0
            for i in replace.surplus_instances():
                for task_spec in pod.tasks:
                    full = task_full_name(pod.type, i, task_spec.name)
                    for res in list(scheduler.ledger.for_task(full)):
                        scheduler.ledger.release(res.reservation_id)
                    if scheduler.state_store.fetch_task(full) is not None:
                        scheduler.state_store.clear_task(full)
                        erased += 1
            if erased and scheduler.journal is not None:
                scheduler.journal.append(
                    "recovery", pod=pod.type, verb="trim-surplus",
                    tasks=erased,
                    message=f"erased {erased} surplus task(s) after "
                            f"elastic re-slice of {pod.type}",
                )
            return True

        steps: List[Step] = [
            ActionStep(
                f"kill-{pod.type}-survivors", kill_survivors, assets=assets
            ),
            ActionStep(
                f"unreserve-{pod.type}-slice", unreserve_slice, assets=assets
            ),
            replace,
            ActionStep(
                f"trim-{pod.type}-surplus", trim_surplus, assets=assets
            ),
        ]
        phase = Phase(phase_name, steps, SerialStrategy())
        phase.gang_recovery = True
        return phase
