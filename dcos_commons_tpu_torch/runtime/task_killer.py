"""TaskKiller: kill with retries until a terminal status lands.

Reference: framework/TaskKiller.java — kills are recorded and
re-issued every cycle until the state store shows a terminal status
for the task id, surviving lost kill requests and scheduler restarts
(pending kills are re-derived from non-terminal statuses of tasks
flagged for killing).

Port of ``dcos_commons_tpu/runtime/task_killer.py``, line for line but the imports.
"""

from __future__ import annotations

import threading
from typing import Dict, Set

from dcos_commons_tpu_torch.agent.base import Agent
from dcos_commons_tpu_torch.common import TaskStatus


class TaskKiller:
    def __init__(self, agent: Agent):
        self._agent = agent
        self._pending: Dict[str, float] = {}  # task_id -> grace period
        self._lock = threading.Lock()

    def kill(self, task_id: str, grace_period_s: float = 0.0) -> None:
        with self._lock:
            self._pending[task_id] = grace_period_s
        self._agent.kill(task_id, grace_period_s)

    def handle_status(self, status: TaskStatus) -> None:
        if status.state.is_terminal:
            with self._lock:
                self._pending.pop(status.task_id, None)

    def retry_pending(self) -> None:
        """Called each scheduler cycle: re-issue unacknowledged kills."""
        with self._lock:
            pending = dict(self._pending)
        active = self._agent.active_task_ids()
        for task_id, grace in pending.items():
            if task_id in active:
                self._agent.kill(task_id, grace)

    def pending_ids(self) -> Set[str]:
        with self._lock:
            return set(self._pending)
