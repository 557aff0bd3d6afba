"""Plan factories: ServiceSpec + persisted state -> deploy plan.

Reference: plan/DeployPlanFactory.java, DefaultPhaseFactory.java,
DefaultStepFactory.java — the step factory consults the StateStore to
decide each step's initial status: a task already launched at the
target config and at its goal state yields a COMPLETE step, so
scheduler restarts resume plans mid-step (SchedulerRestartServiceTest
is the reference's proof; our test_plan_resume mirrors it).

Port of ``dcos_commons_tpu/plan/builders.py``, line for line but
the imports and ``pod.gpu`` for ``pod.tpu``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from dcos_commons_tpu_torch.common import Label
from dcos_commons_tpu_torch.plan.backoff import Backoff
from dcos_commons_tpu_torch.plan.phase import Phase
from dcos_commons_tpu_torch.plan.plan import DEPLOY_PLAN_NAME, Plan
from dcos_commons_tpu_torch.plan.step import DeploymentStep, PodInstanceRequirement
from dcos_commons_tpu_torch.plan.strategy import strategy_for_name
from dcos_commons_tpu_torch.specification.specs import (
    PodSpec,
    ServiceSpec,
    task_full_name,
)
from dcos_commons_tpu_torch.state.state_store import StateStore


def build_instance_steps(
    pod: PodSpec,
    instances: List[int],
    state_store: StateStore,
    target_config_id: str,
    backoff: Optional[Backoff] = None,
) -> List[DeploymentStep]:
    """One deployment step per listed instance of a NON-GANG pod,
    seeded from persisted state exactly like the deploy plan's own
    steps (an already-launched instance restores COMPLETE).  The
    autoscale scale-out phase (health/actions.py) builds its new
    instances through this, so an automated scale-out deploys through
    the identical launch path — and re-synthesizing the phase after a
    failover can never re-deploy what already landed."""
    factory = DeployPlanFactory(backoff)
    return [
        factory._make_step(pod, [index], state_store, target_config_id)
        for index in instances
    ]


class DeployPlanFactory:
    """Builds the default deploy plan: one phase per pod, serial over
    phases; parallel gang pods get one step covering all instances."""

    def __init__(self, backoff: Optional[Backoff] = None):
        self._backoff = backoff

    def build(
        self,
        spec: ServiceSpec,
        state_store: StateStore,
        target_config_id: str,
        plan_name: str = DEPLOY_PLAN_NAME,
    ) -> Plan:
        phases = [
            self.build_phase(pod, state_store, target_config_id)
            for pod in spec.pods
        ]
        return Plan(plan_name, phases, strategy_for_name("serial"))

    def build_phase(
        self,
        pod: PodSpec,
        state_store: StateStore,
        target_config_id: str,
        strategy_name: str = "serial",
        phase_name: str = "",
    ) -> Phase:
        steps: List[DeploymentStep] = []
        if pod.gang:
            # one step = the whole gang (one process group)
            steps.append(
                self._make_step(
                    pod, list(range(pod.count)), state_store, target_config_id
                )
            )
        else:
            for index in range(pod.count):
                steps.append(
                    self._make_step(pod, [index], state_store, target_config_id)
                )
        return Phase(
            phase_name or pod.type, steps, strategy_for_name(strategy_name)
        )

    def _make_step(
        self,
        pod: PodSpec,
        instances: List[int],
        state_store: StateStore,
        target_config_id: str,
    ) -> DeploymentStep:
        requirement = PodInstanceRequirement(pod=pod, instances=instances)
        name = (
            f"{pod.type}-{instances[0]}:[{','.join(requirement.tasks_to_launch)}]"
            if len(instances) == 1
            else f"{pod.type}-gang:[{','.join(requirement.tasks_to_launch)}]"
        )
        step = DeploymentStep(name, requirement, backoff=self._backoff)
        self.seed_step_from_state(step, pod, instances, state_store, target_config_id)
        return step

    def seed_step_from_state(
        self,
        step: DeploymentStep,
        pod: PodSpec,
        instances: List[int],
        state_store: StateStore,
        target_config_id: str,
    ) -> None:
        """Resume semantics: replay persisted launches + statuses into
        the fresh step (reference: DefaultStepFactory.getStatus)."""
        expected: Dict[str, str] = {}
        statuses = []
        missing: List[int] = []
        for index in instances:
            for task_name in step.requirement.tasks_to_launch:
                full = task_full_name(pod.type, index, task_name)
                info = state_store.fetch_task(full)
                if info is None:
                    missing.append(index)
                    break  # never launched for this instance
                if info.labels.get(Label.TARGET_CONFIG) != target_config_id:
                    return  # old config: needs redeploy -> PENDING
                if info.labels.get(Label.PERMANENTLY_FAILED):
                    return  # needs replacement, recovery will claim it
                expected[full] = info.task_id
                status = state_store.fetch_status(full)
                if status is not None:
                    statuses.append(status)
        if missing:
            # A missing clean SUFFIX of an elastic gang whose initial
            # deployment already completed is an elastic shrink's
            # trim-surplus erase, not an interrupted
            # deploy: seed the surviving prefix as launched so the
            # restart-rebuilt plan re-derives COMPLETE.  The width is
            # the recovery manager's business — its regrow scan
            # (_maybe_regrow) re-places the gang at declared width
            # when capacity returns; a PENDING full-width step here
            # would instead deadlock against the survivors' own
            # reservations while blocking regrow as externally
            # managed.  Any other hole stays PENDING.
            elastic_gang = (
                pod.gang and pod.gpu is not None and pod.gpu.elastic
            )
            suffix = list(range(min(missing), max(instances) + 1))
            is_clean_suffix = missing == suffix and min(missing) > min(
                instances
            )
            if not (
                elastic_gang
                and is_clean_suffix
                and state_store.deployment_was_completed()
            ):
                return  # never launched: step stays PENDING
        # ONCE tasks that already FINISHED must not re-run even though
        # a fresh launch would: mark complete directly
        step.record_launch(expected)
        for status in statuses:
            step.update(status)
