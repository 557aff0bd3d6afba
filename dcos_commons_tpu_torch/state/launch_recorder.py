"""PersistentLaunchRecorder: WAL TaskInfos *before* launching.

Reference: state/PersistentLaunchRecorder.java, invoked at
DefaultScheduler.java:454-455 — every launch recommendation is written
to the state store before the accept call goes to Mesos, so a
scheduler crash between "decide" and "launch" resumes with the task
recorded (and reconciliation then discovers whether it actually
launched).  This idempotent WAL-before-act discipline is what makes
the control plane crash-restart safe (SURVEY.md section 7 hard part 1).

Port of ``dcos_commons_tpu/state/launch_recorder.py``,
line for line but the imports.
"""

from __future__ import annotations

from typing import List, Optional

from dcos_commons_tpu_torch.common import TaskInfo
from dcos_commons_tpu_torch.state.state_store import StateStore
from dcos_commons_tpu_torch.trace.recorder import NULL_TRACER


class PersistentLaunchRecorder:
    def __init__(self, state_store: StateStore, tracer=None) -> None:
        self._state_store = state_store
        self._tracer = tracer

    def record(
        self, infos: List[TaskInfo], parent: Optional[object] = None
    ) -> None:
        """Atomically persist the pod's TaskInfos + seeded STAGING statuses.

        One persister transaction: a crash can never leave a gang launch
        half-recorded.  The STAGING seed gives reconciliation something
        to reconcile if the actual launch was lost in the crash.

        ``parent`` is the launch span: the WAL write is timed as its
        child (a slow persister shows up ON the launch it slowed).
        """
        tracer = self._tracer or NULL_TRACER
        with tracer.span(
            "launch.wal", parent=parent, track="scheduler",
            tasks=",".join(i.name for i in infos),
            task_ids=",".join(i.task_id for i in infos),
        ):
            self._state_store.store_launch(infos)
