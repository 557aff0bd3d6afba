"""DecommissionPlanFactory: state-vs-spec diff -> teardown plan.

Reference: scheduler/decommission/DecommissionPlanFactory.java — for
each surplus pod instance, a serial step sequence: mark + kill its
tasks (TriggerDecommissionStep), unreserve its resources
(ResourceCleanupStep analogue over the reservation ledger), erase its
task state (EraseTaskStateStep).  Highest indices decommission first,
so the surviving instances are always the dense prefix 0..count-1.

The plan is re-derived from the state diff on every scheduler
(re)build, which makes each step idempotent — a crash mid-teardown
resumes by recomputing what is still surplus.

Port of ``dcos_commons_tpu/decommission/factory.py``,
line for line but the imports.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from dcos_commons_tpu_torch.common import TaskInfo
from dcos_commons_tpu_torch.plan.phase import Phase
from dcos_commons_tpu_torch.plan.plan import Plan
from dcos_commons_tpu_torch.plan.step import ActionStep
from dcos_commons_tpu_torch.plan.strategy import SerialStrategy
from dcos_commons_tpu_torch.specification.specs import (
    ServiceSpec,
    pod_instance_name,
    task_full_name,
)
from dcos_commons_tpu_torch.state.state_store import StateStore

DECOMMISSION_PLAN_NAME = "decommission"


def find_surplus_instances(
    spec: ServiceSpec, state_store: StateStore
) -> List[Tuple[str, int, List[str]]]:
    """(pod_type, index, task full-names) for every stored pod instance
    the target spec no longer covers, highest indices first."""
    by_instance: Dict[Tuple[str, int], List[TaskInfo]] = {}
    for info in state_store.fetch_tasks():
        by_instance.setdefault((info.pod_type, info.pod_index), []).append(info)
    known_pods = {p.type: p for p in spec.pods}
    surplus = []
    for (pod_type, index), infos in by_instance.items():
        pod = known_pods.get(pod_type)
        if pod is not None and index < pod.count:
            continue
        surplus.append((pod_type, index, sorted(i.name for i in infos)))
    surplus.sort(key=lambda s: (s[0], -s[1]))
    return surplus


class DecommissionPlanFactory:
    def build(
        self, spec: ServiceSpec, state_store: StateStore,
        exclude: Optional[Set[str]] = None,
    ) -> Plan:
        """``exclude`` names pod instances some OTHER plan already
        owns the teardown of — the builder passes the victims of
        journal-latched in-flight scale-in actions, whose
        re-synthesized phases tear down through the router drain
        grace.  Without the exclusion, a failover mid-scale-in races
        this plan's drain-less kill step against the scale-in's
        drain step for the same instance, and the kill wins."""
        # kill grace periods come from the current spec; tasks of a pod
        # type the spec dropped entirely fall back to immediate kill.
        # The map is keyed by FULL task name (pod-index-task): suffix
        # parsing of stored names would mis-key task specs whose names
        # contain dashes.
        known_pods = {p.type: p for p in spec.pods}
        phases = []
        for pod_type, index, task_names in find_surplus_instances(
            spec, state_store
        ):
            if exclude and pod_instance_name(pod_type, index) in exclude:
                continue
            grace_by_full: Dict[str, float] = {}
            pod = known_pods.get(pod_type)
            if pod is not None:
                for task_spec in pod.tasks:
                    full = task_full_name(pod_type, index, task_spec.name)
                    grace_by_full[full] = task_spec.kill_grace_period_s
            phases.append(
                self._build_phase(pod_type, index, task_names, grace_by_full)
            )
        return Plan(DECOMMISSION_PLAN_NAME, phases, SerialStrategy())

    def _build_phase(
        self,
        pod_type: str,
        index: int,
        task_names: List[str],
        grace_by_full: Dict[str, float],
    ) -> Phase:
        instance = pod_instance_name(pod_type, index)
        phase = Phase(
            f"decommission-{instance}",
            instance_teardown_steps(
                pod_type, index, task_names, grace_by_full
            ),
            SerialStrategy(),
        )
        # endpoint assembly consults ACTIVE teardown targets: the
        # router must see draining:true and stop placing BEFORE any
        # kill fires, even while the backend's task and host are
        # still perfectly healthy (previously
        # only host-level drain flipped the rows)
        phase.decommission_targets = {instance}
        return phase


def instance_teardown_steps(
    pod_type: str,
    index: int,
    task_names: List[str],
    grace_by_full: Dict[str, float],
) -> List[ActionStep]:
    """The kill -> unreserve -> erase step triple for one pod
    instance — the decommission choreography, shared by the surplus
    decommission plan above and the autoscale scale-in phase
    (health/actions.py).  Every step is idempotent: a successor
    re-running them against an already-clean world completes them
    immediately."""
    instance = pod_instance_name(pod_type, index)
    asset = {instance}

    def kill_tasks(scheduler) -> bool:
        """TriggerDecommissionStep + kill: issue graceful kills,
        done when every task is terminally stopped."""
        all_done = True
        for name in task_names:
            info = scheduler.state_store.fetch_task(name)
            if info is None:
                continue
            status = scheduler.state_store.fetch_status(name)
            if status is not None and status.state.is_terminal:
                continue
            grace = grace_by_full.get(name, 0.0)
            scheduler.task_killer.kill(info.task_id, grace)
            all_done = False
        return all_done

    def unreserve(scheduler) -> bool:
        for name in task_names:
            for reservation in scheduler.ledger.for_task(name):
                scheduler.ledger.release(reservation.reservation_id)
                scheduler.metrics.incr("operations.unreserve")
        return True

    def erase(scheduler) -> bool:
        for name in task_names:
            scheduler.state_store.clear_task(name)
        return True

    return [
        ActionStep(f"kill-{instance}", kill_tasks, assets=asset),
        ActionStep(f"unreserve-{instance}", unreserve, assets=asset),
        ActionStep(f"erase-{instance}", erase, assets=asset),
    ]


def build_scale_in_phase(
    pod,
    index: int,
    shrink_action,
    drain_action,
    to_count: int,
) -> Phase:
    """The autoscale scale-in choreography, one serial phase:

        shrink      the count verb — the victim becomes SURPLUS first,
                    so the recovery scan stops owning it before
                    anything dies (killing a still-owned instance
                    would race a recovery relaunch)
        drain       waits out the router drain grace; the phase's
                    ``decommission_targets`` flipped the victim's
                    /v1/endpoints rows to draining:true the moment the
                    phase was created, so by the time this step
                    completes the front door stopped placing
        kill/unreserve/erase
                    the decommission factory's step triple

    Restart-safe: shrink is idempotent (the count verb no-ops at the
    target), the teardown steps are idempotent, and a failover that
    lost the drain clock re-drains for the FULL grace — conservative,
    never shorter."""
    instance = pod_instance_name(pod.type, index)
    asset = {instance}
    task_names = sorted(
        task_full_name(pod.type, index, t.name) for t in pod.tasks
    )
    grace_by_full = {
        task_full_name(pod.type, index, t.name): t.kill_grace_period_s
        for t in pod.tasks
    }
    steps = [
        ActionStep(f"shrink-{pod.type}-to-{to_count}", shrink_action,
                   assets=asset),
        ActionStep(f"drain-{instance}", drain_action, assets=asset),
        *instance_teardown_steps(
            pod.type, index, task_names, grace_by_full
        ),
    ]
    phase = Phase(f"scale-in-{instance}", steps, SerialStrategy())
    phase.decommission_targets = {instance}
    return phase
