"""Plan: an ordered set of phases under one strategy.

Reference: scheduler/plan/Plan.java:23; deploy/update/recovery/
decommission/uninstall are all just Plans with well-known names
(offer/Constants.java).

Port of ``dcos_commons_tpu/plan/plan.py``,
line for line but the imports.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Set

from dcos_commons_tpu_torch.common import TaskStatus
from dcos_commons_tpu_torch.plan.element import Element
from dcos_commons_tpu_torch.plan.phase import Phase
from dcos_commons_tpu_torch.plan.status import Status, aggregate
from dcos_commons_tpu_torch.plan.step import Step
from dcos_commons_tpu_torch.plan.strategy import SerialStrategy, Strategy

DEPLOY_PLAN_NAME = "deploy"
UPDATE_PLAN_NAME = "update"
RECOVERY_PLAN_NAME = "recovery"
DECOMMISSION_PLAN_NAME = "decommission"
UNINSTALL_PLAN_NAME = "uninstall"


class Plan(Element):
    def __init__(self, name: str, phases: Sequence[Phase], strategy: Strategy = None):
        super().__init__(name)
        self.phases: List[Phase] = list(phases)
        self.strategy = strategy or SerialStrategy()

    def get_status(self) -> Status:
        if self.has_errors():
            return Status.ERROR
        return aggregate(
            (p.get_status() for p in self.phases),
            interrupted=self.strategy.is_interrupted(),
        )

    def candidates(self, dirty_assets: Set[str]) -> List[Step]:
        steps: List[Step] = []
        for phase in self.strategy.candidates(self.phases, dirty_assets):
            if isinstance(phase, Phase):
                steps.extend(phase.candidates(dirty_assets))
        return steps

    def update(self, status: TaskStatus) -> None:
        for phase in self.phases:
            phase.update(status)

    def interrupt(self) -> None:
        self.strategy.interrupt()

    def proceed(self) -> None:
        self.strategy.proceed()

    def is_interrupted(self) -> bool:
        return self.strategy.is_interrupted()

    def restart(self) -> None:
        for phase in self.phases:
            phase.restart()

    def set_env_overrides(self, env: dict) -> None:
        """Parameterized start: merge operator env into every step's
        launch requirement (reference: PlansQueries start-with-env).
        Sticky until the next parameterized start — re-running a
        backup plan without params reuses the previous target."""
        for phase in self.phases:
            for step in phase.steps:
                requirement = getattr(step, "requirement", None)
                if requirement is not None:
                    requirement.env_overrides = dict(env)

    def force_complete(self) -> None:
        for phase in self.phases:
            phase.force_complete()

    # lookup helpers (used by the HTTP API's plan verbs) -------------

    def phase(self, name_or_id: str) -> Optional[Phase]:
        for phase in self.phases:
            if name_or_id in (phase.name, phase.id):
                return phase
        return None

    def step(self, phase_name: str, step_name: str) -> Optional[Step]:
        phase = self.phase(phase_name)
        if phase is None:
            return None
        for step in phase.steps:
            if step_name in (step.name, step.id):
                return step
        return None

    def all_steps(self) -> List[Step]:
        return [s for p in self.phases for s in p.steps]
