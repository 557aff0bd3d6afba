"""FakeAgent: the scripted stand-in for the whole fleet.

Plays the role the mocked SchedulerDriver plays in the reference's sim
harness (reference: sdk/testing/.../ServiceTestRunner.java wires a
Mockito SchedulerDriver; launches/kills are captured, statuses are
injected by `SendTaskStatus` ticks).  Nothing actually runs: launches
are recorded, kills are recorded (and by default acknowledged with a
TASK_KILLED status, since that is what a healthy agent would report),
and tests inject every other status transition explicitly.

Port of ``dcos_commons_tpu/testing/fake_agent.py``, line for line but the imports.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set

from dcos_commons_tpu_torch.common import TaskInfo, TaskState, TaskStatus


class FakeAgent:
    def __init__(self, auto_ack_kills: bool = True):
        self.auto_ack_kills = auto_ack_kills
        # full launch history, in order (never pruned: tests assert on it)
        self.launched: List[TaskInfo] = []
        # kill-call history (task ids, duplicates possible via retries)
        self.kills: List[str] = []
        # last grace period passed to kill() per task id
        self.kill_graces: Dict[str, float] = {}
        self.checks: Dict[str, Dict[str, object]] = {}
        self.payloads: Dict[str, Dict[str, object]] = {}
        # artifact (uris:) entries per launched task id
        self.launch_uris: Dict[str, List[dict]] = {}
        self._active: Dict[str, TaskInfo] = {}
        self._queue: List[TaskStatus] = []
        self._acked_kills: Set[str] = set()
        self.launch_rlimits: Dict[str, list] = {}
        self._lock = threading.RLock()

    # -- Agent interface ---------------------------------------------

    def launch(self, task_infos: List[TaskInfo]) -> None:
        for info in task_infos:
            self.launch_one(info)

    def launch_one(self, info: TaskInfo, readiness=None, health=None,
                   templates=None, files=None, secret_env=None,
                   kill_grace_s: float = 5.0, uris=None,
                   rlimits=None) -> None:
        with self._lock:
            if info.task_id in self._active:
                return  # idempotent, like the real agent
            self._active[info.task_id] = info
            self.launched.append(info)
            self.launch_uris[info.task_id] = list(uris or [])
            self.launch_rlimits[info.task_id] = list(rlimits or [])
            self.checks[info.task_id] = {
                "readiness": readiness,
                "health": health,
            }
            # recorded for Expect assertions (secret files, TLS PEMs)
            self.payloads[info.task_id] = {
                "templates": templates or [],
                "files": files or [],
                "secret_env": dict(secret_env or {}),
            }

    def kill(self, task_id: str, grace_period_s: float = 0.0) -> None:
        with self._lock:
            self.kills.append(task_id)
            self.kill_graces[task_id] = grace_period_s
            if task_id not in self._active:
                return
            if self.auto_ack_kills and task_id not in self._acked_kills:
                self._acked_kills.add(task_id)
                self.send(
                    TaskStatus(
                        task_id=task_id,
                        state=TaskState.KILLED,
                        message="killed by scheduler",
                        agent_id=self._active[task_id].agent_id,
                    )
                )

    def active_task_ids(self) -> Set[str]:
        with self._lock:
            return set(self._active)

    def poll(self) -> List[TaskStatus]:
        with self._lock:
            out = list(self._queue)
            self._queue.clear()
            return out

    # -- scripting surface -------------------------------------------

    def send(self, status: TaskStatus) -> None:
        """Queue a status for the scheduler's next poll; terminal
        statuses also remove the task from the active set (the process
        is gone).  Registered status listeners are notified so an
        event-driven scheduler loop wakes immediately."""
        with self._lock:
            self._queue.append(status)
            if status.state.is_terminal:
                self._active.pop(status.task_id, None)
            listeners = list(getattr(self, "_status_listeners", []))
        for listener in listeners:
            try:
                listener()
            except Exception:  # sdklint: disable=swallowed-exception — same contract as Agent._notify_status: a broken listener must not break intake
                pass

    def add_status_listener(self, listener) -> None:
        """Event-driven wake hook (same contract as Agent's)."""
        with self._lock:
            if not hasattr(self, "_status_listeners"):
                self._status_listeners = []
            self._status_listeners.append(listener)

    def task_id_of(self, task_name: str) -> Optional[str]:
        """Most recent launched task id for a task full-name."""
        with self._lock:
            for info in reversed(self.launched):
                if info.name == task_name:
                    return info.task_id
            return None

    def task_info_of(self, task_name: str) -> Optional[TaskInfo]:
        with self._lock:
            for info in reversed(self.launched):
                if info.name == task_name:
                    return info
            return None

    def launches_of(self, task_name: str) -> List[TaskInfo]:
        with self._lock:
            return [i for i in self.launched if i.name == task_name]

    def killed_names(self) -> List[str]:
        from dcos_commons_tpu_torch.common import task_name_of

        out = []
        with self._lock:
            for task_id in self.kills:
                try:
                    out.append(task_name_of(task_id))
                except ValueError:
                    pass
        return out

    def fail_host(self, host_id: str) -> List[str]:
        """Preemption semantics: every task process on ``host_id``
        dies SILENTLY — no terminal status is ever reported (the
        machine is gone, nothing is left to report it).  Returns the
        reaped task ids.  Detection is the control plane's job: the
        preempt verb / agent plane synthesizes the TASK_LOSTs."""
        with self._lock:
            gone = [
                task_id
                for task_id, info in self._active.items()
                if info.agent_id == host_id
            ]
            for task_id in gone:
                self._active.pop(task_id, None)
            return gone

    def shutdown(self) -> None:
        with self._lock:
            self._active.clear()
            self._queue.clear()
