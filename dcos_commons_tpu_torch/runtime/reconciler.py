"""Reconciler: align stored task state with agent reality at startup.

Reference: scheduler/ExplicitReconciler.java + framework/
ImplicitReconciler.java — on (re)registration the scheduler asks the
master for the status of every known task and gates offer processing
until the answers arrive (AbstractScheduler.java:163-184).  Here the
agents are authoritative: any task the store believes is live but no
agent knows is synthesized as TASK_LOST, which flows through the
normal status path and triggers recovery.  This is what makes the
WAL-before-launch discipline safe: a crash between WAL and launch
leaves a STAGING record that reconciliation converts to LOST.

Port of ``dcos_commons_tpu/runtime/reconciler.py``, line for line but the imports.
"""

from __future__ import annotations

from typing import List

from dcos_commons_tpu_torch.agent.base import Agent
from dcos_commons_tpu_torch.common import TaskState, TaskStatus
from dcos_commons_tpu_torch.state.state_store import StateStore


class Reconciler:
    def __init__(self, state_store: StateStore, agent: Agent):
        self._state_store = state_store
        self._agent = agent
        self._done = False

    @property
    def is_reconciled(self) -> bool:
        return self._done

    def reconcile(self) -> List[TaskStatus]:
        """Returns synthesized LOST statuses for vanished tasks."""
        # explicit reconciliation: agents that report transitions
        # edge-triggered (LocalProcessAgent) re-arm the CURRENT state
        # of live tasks for the next poll — without this, statuses a
        # dead predecessor drained but never acted on are lost, and an
        # adopted task can sit at store-STAGING forever
        request = getattr(self._agent, "reconcile", None)
        if callable(request):
            request()
        active = self._agent.active_task_ids()
        synthesized: List[TaskStatus] = []
        for name, status in self._state_store.fetch_statuses().items():
            if status.state.is_terminal:
                continue
            if status.task_id not in active:
                synthesized.append(
                    TaskStatus(
                        task_id=status.task_id,
                        state=TaskState.LOST,
                        message="reconciliation: agent does not know this task",
                        agent_id=status.agent_id,
                    )
                )
        self._done = True
        return synthesized

    def reset(self) -> None:
        self._done = False
