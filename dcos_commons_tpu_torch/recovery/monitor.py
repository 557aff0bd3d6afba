"""Failure monitors: when does TRANSIENT escalate to PERMANENT?

Reference: recovery/monitor/ — NeverFailureMonitor (default: always
relaunch in place), TimedFailureMonitor.java:20-60 (a task failing
continuously for longer than ReplacementFailurePolicy's
permanent-failure-timeout is declared permanently failed),
TestingFailureMonitor (fault injection for the sim harness).

Port of ``dcos_commons_tpu/recovery/monitor.py``,
line for line but the imports.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional

from dcos_commons_tpu_torch.common import TaskStatus


class FailureMonitor:
    def has_failed_permanently(self, task_name: str, status: TaskStatus) -> bool:
        raise NotImplementedError

    def clear(self, task_name: str) -> None:
        pass


class NeverFailureMonitor(FailureMonitor):
    def has_failed_permanently(self, task_name: str, status: TaskStatus) -> bool:
        return False


class TimedFailureMonitor(FailureMonitor):
    """Permanent once a task has been failing for longer than
    ``permanent_failure_timeout_s`` (measured from the first observed
    failure; cleared when the task recovers)."""

    def __init__(self, permanent_failure_timeout_s: float,
                 clock=time.monotonic):
        self._timeout = permanent_failure_timeout_s
        self._first_failure: Dict[str, float] = {}
        self._clock = clock

    def has_failed_permanently(self, task_name: str, status: TaskStatus) -> bool:
        # called for statuses already classified as needing recovery
        # (any terminal state short of the goal, incl. KILLED/LOST)
        if not status.state.is_terminal:
            self.clear(task_name)
            return False
        now = self._clock()
        first = self._first_failure.setdefault(task_name, now)
        return (now - first) >= self._timeout

    def clear(self, task_name: str) -> None:
        self._first_failure.pop(task_name, None)


class TestingFailureMonitor(FailureMonitor):
    """Fault injection: the named tasks always escalate to PERMANENT."""

    __test__ = False  # not a pytest class

    def __init__(self, permanent_tasks: Optional[Iterable[str]] = None):
        self.permanent_tasks = set(permanent_tasks or [])

    def has_failed_permanently(self, task_name: str, status: TaskStatus) -> bool:
        return status.state.is_terminal and task_name in self.permanent_tasks
