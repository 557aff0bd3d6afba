"""Phase: an ordered set of steps under one strategy.

Reference: scheduler/plan/Phase.java:12, DefaultPhaseFactory.

Port of ``dcos_commons_tpu/plan/phase.py``,
line for line but the imports.
"""

from __future__ import annotations

from typing import List, Sequence, Set

from dcos_commons_tpu_torch.common import TaskStatus
from dcos_commons_tpu_torch.plan.element import Element
from dcos_commons_tpu_torch.plan.status import Status, aggregate
from dcos_commons_tpu_torch.plan.step import Step
from dcos_commons_tpu_torch.plan.strategy import SerialStrategy, Strategy


class Phase(Element):
    def __init__(self, name: str, steps: Sequence[Step], strategy: Strategy = None):
        super().__init__(name)
        self.steps: List[Step] = list(steps)
        self.strategy = strategy or SerialStrategy()

    def get_status(self) -> Status:
        if self.has_errors():
            return Status.ERROR
        return aggregate(
            (s.get_status() for s in self.steps),
            interrupted=self.strategy.is_interrupted(),
        )

    def candidates(self, dirty_assets: Set[str]) -> List[Step]:
        return [
            s for s in self.strategy.candidates(self.steps, dirty_assets)
            if isinstance(s, Step)
        ]

    def update(self, status: TaskStatus) -> None:
        for step in self.steps:
            step.update(status)

    def interrupt(self) -> None:
        self.strategy.interrupt()

    def proceed(self) -> None:
        self.strategy.proceed()

    def is_interrupted(self) -> bool:
        return self.strategy.is_interrupted()

    def restart(self) -> None:
        for step in self.steps:
            step.restart()

    def force_complete(self) -> None:
        for step in self.steps:
            step.force_complete()
