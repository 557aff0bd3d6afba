"""PlanManager: owns one plan — candidates + status routing.

Reference: scheduler/plan/PlanManager.java:14-42,
DefaultPlanManager.java.

Port of ``dcos_commons_tpu/plan/plan_manager.py``,
line for line but the imports.
"""

from __future__ import annotations

from typing import List, Set

from dcos_commons_tpu_torch.common import TaskStatus
from dcos_commons_tpu_torch.plan.plan import Plan
from dcos_commons_tpu_torch.plan.step import Step


class PlanManager:
    def get_plan(self) -> Plan:
        raise NotImplementedError

    def get_candidates(self, dirty_assets: Set[str]) -> List[Step]:
        raise NotImplementedError

    def update(self, status: TaskStatus) -> None:
        raise NotImplementedError

    def set_transition_listener(self, listener) -> None:
        """Attach the traceview step-transition hook to every step this
        manager currently owns.  Managers that mint steps dynamically
        (recovery) are covered because the scheduler re-wires at the
        top of every cycle, before statuses route."""
        for step in self.get_plan().all_steps():
            step.transition_listener = listener

    def in_progress_assets(self) -> Set[str]:
        """Assets of steps currently holding resources mid-transition;
        used by the coordinator for mutual exclusion."""
        assets: Set[str] = set()
        for step in self.get_plan().all_steps():
            if step.get_status().is_running:
                assets |= step.get_asset_names()
        return assets


class DefaultPlanManager(PlanManager):
    """Reference: plan/DefaultPlanManager.java — wraps a static plan."""

    def __init__(self, plan: Plan):
        self._plan = plan

    def get_plan(self) -> Plan:
        return self._plan

    def get_candidates(self, dirty_assets: Set[str]) -> List[Step]:
        if self._plan.is_complete:
            return []
        return self._plan.candidates(dirty_assets)

    def update(self, status: TaskStatus) -> None:
        self._plan.update(status)
