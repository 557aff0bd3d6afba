"""PlanCoordinator: merge candidates across plans without collisions.

Reference: scheduler/plan/DefaultPlanCoordinator.java:33-90 — collects
candidate steps from every plan manager while tracking *dirtied
assets* (pod instances already being worked) so two plans (e.g. deploy
and recovery) never touch the same pod simultaneously.

Port of ``dcos_commons_tpu/plan/coordinator.py``,
line for line but the imports.
"""

from __future__ import annotations

from typing import List, Sequence, Set

from dcos_commons_tpu_torch.plan.plan_manager import PlanManager
from dcos_commons_tpu_torch.plan.step import Step


class DefaultPlanCoordinator:
    def __init__(self, plan_managers: Sequence[PlanManager]):
        # order = priority: earlier managers claim assets first
        # (the scheduler passes recovery before deploy, as the
        # reference does via plan manager ordering)
        self._managers: List[PlanManager] = list(plan_managers)

    @property
    def plan_managers(self) -> List[PlanManager]:
        return self._managers

    def get_candidates(self) -> List[Step]:
        dirty: Set[str] = set()
        for manager in self._managers:
            dirty |= manager.in_progress_assets()
        candidates: List[Step] = []
        for manager in self._managers:
            for step in manager.get_candidates(set(dirty)):
                assets = step.get_asset_names()
                if assets & dirty:
                    continue
                dirty |= assets
                candidates.append(step)
        return candidates

    def has_work(self) -> bool:
        """New-work signal feeding revive/suppress decisions
        (reference: WorkSetTracker / AbstractScheduler.java:136-160)."""
        return bool(self.get_candidates()) or any(
            not m.get_plan().is_complete and not m.get_plan().is_interrupted()
            and not m.get_plan().has_errors()
            for m in self._managers
        )

    def work_set(self) -> Set[str]:
        """The names of current candidate steps (revive detection)."""
        return {step.name for step in self.get_candidates()}
