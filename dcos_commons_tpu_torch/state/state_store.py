"""StateStore: CRUD for TaskInfo/TaskStatus/properties/goal overrides.

Reference: state/StateStore.java:58,213-569 and
state/GoalStateOverride.java (the PAUSED state machine behind
``pod pause``/``resume``, http/queries/PodQueries.java:183-203).

Layout under the service namespace:
    /tasks/<task_name>/info        TaskInfo JSON
    /tasks/<task_name>/status      TaskStatus JSON
    /tasks/<task_name>/override    goal-state override JSON
    /properties/<key>              raw bytes

Port of ``dcos_commons_tpu/state/state_store.py``,
line for line but the imports.
"""

from __future__ import annotations

import enum
import json
import threading
from typing import Dict, List, Optional

from dcos_commons_tpu_torch.common import TaskInfo, TaskState, TaskStatus
from dcos_commons_tpu_torch.storage import Persister, PersisterError, SetOp
from dcos_commons_tpu_torch.storage.persister import namespace_root


class StateStoreException(Exception):
    pass


class GoalStateOverride(enum.Enum):
    """Reference: state/GoalStateOverride.java — NONE or PAUSED."""

    NONE = "NONE"
    PAUSED = "PAUSED"


class OverrideProgress(enum.Enum):
    """Progress of applying an override (relaunch w/ sleep cmd)."""

    COMPLETE = "COMPLETE"
    PENDING = "PENDING"
    IN_PROGRESS = "IN_PROGRESS"


class StateStore:
    def __init__(self, persister: Persister, namespace: str = "") -> None:
        self._persister = persister
        # namespacing supports multi-service mode, where each service
        # gets its own subtree (reference: SchedulerBuilder namespacing,
        # scheduler/multi/).
        self._root = namespace_root(namespace)
        self._lock = threading.RLock()
        # decode cache: path -> (raw bytes, decoded object).  The
        # persister read stays authoritative (correct under external
        # writers — HA failover, multi mode); only the JSON decode is
        # skipped, and only when the fetched bytes are EQUAL to the
        # cached ones.  Fetched objects are treated as immutable
        # everywhere (with_label copies), so sharing is safe.  At
        # fleet scale the recovery scan fetches every task each cycle:
        # decoding ~1000 identical JSON blobs per cycle was the
        # scheduler loop's single largest cost.
        self._decode_cache: Dict[str, tuple] = {}
        # task-subtree change stamp for generation-stamped readers
        # (the /v1/endpoints discovery contract): every
        # info/status/override mutation bumps it, so a quiet fleet's
        # endpoint poll is one compare.  Per-OBJECT counter + epoch,
        # the ReservationLedger discipline: a rebuilt store (failover,
        # live update) re-bases counters under a fresh epoch so stale
        # stamps can never alias
        import uuid as _uuid

        self._task_mutation = 0
        self._task_epoch = _uuid.uuid4().hex[:12]

    @property
    def task_generation(self) -> str:
        """Opaque change stamp of the task subtree (epoch-qualified
        mutation counter): equal stamps guarantee an identical task/
        status/override set, so endpoint discovery can skip rebuilds."""
        with self._lock:
            return f"{self._task_epoch}.{self._task_mutation}"

    def _bump_task_generation_locked(self) -> None:
        self._task_mutation += 1

    @property
    def persister(self) -> Persister:
        return self._persister

    def _task_path(self, task_name: str, leaf: str = "") -> str:
        if not task_name or "/" in task_name:
            raise StateStoreException(f"invalid task name: {task_name!r}")
        base = f"{self._root}/tasks/{task_name}"
        return f"{base}/{leaf}" if leaf else base

    # -- TaskInfo -----------------------------------------------------

    def store_tasks(self, infos: List[TaskInfo]) -> None:
        """Atomically store TaskInfos (reference: StateStore.storeTasks).

        Written transactionally so the launch WAL semantics hold: either
        every task of a gang-scheduled pod is recorded or none is.
        """
        with self._lock:
            ops = [
                SetOp(self._task_path(info.name, "info"), info.to_bytes())
                for info in infos
            ]
            self._persister.apply(ops)
            self._bump_task_generation_locked()

    def _decode(self, path: str, raw: bytes, decoder):
        with self._lock:
            hit = self._decode_cache.get(path)
            if hit is not None and hit[0] == raw:
                return hit[1]
        obj = decoder(raw)
        with self._lock:
            self._decode_cache[path] = (raw, obj)
        return obj

    def fetch_task(self, task_name: str) -> Optional[TaskInfo]:
        path = self._task_path(task_name, "info")
        raw = self._persister.get_or_none(path)
        if raw is None:
            return None
        return self._decode(path, raw, TaskInfo.from_bytes)

    def fetch_task_names(self) -> List[str]:
        return self._persister.get_children_or_empty(f"{self._root}/tasks")

    def fetch_tasks(self) -> List[TaskInfo]:
        tasks = []
        for name in self.fetch_task_names():
            info = self.fetch_task(name)
            if info is not None:
                tasks.append(info)
        return tasks

    # -- TaskStatus ---------------------------------------------------

    def store_status(self, task_name: str, status: TaskStatus) -> bool:
        """Reference: StateStore.storeStatus (StateStore.java:257).

        The reference validates that the status belongs to the stored
        task-id; stale updates from older launches (normal after a
        relaunch) are dropped rather than crashing the status fan-in.
        Returns False when the update was dropped as stale.
        """
        with self._lock:
            info = self.fetch_task(task_name)
            if info is not None and info.task_id and status.task_id != info.task_id:
                return False
            self._persister.set(
                self._task_path(task_name, "status"), status.to_bytes()
            )
            self._bump_task_generation_locked()
            return True

    def fetch_status(self, task_name: str) -> Optional[TaskStatus]:
        path = self._task_path(task_name, "status")
        raw = self._persister.get_or_none(path)
        if raw is None:
            return None
        return self._decode(path, raw, TaskStatus.from_bytes)

    def fetch_statuses(self) -> Dict[str, TaskStatus]:
        out: Dict[str, TaskStatus] = {}
        for name in self.fetch_task_names():
            status = self.fetch_status(name)
            if status is not None:
                out[name] = status
        return out

    def store_launch(self, infos: List[TaskInfo]) -> None:
        """Atomically WAL a gang launch: every info + a seeded STAGING
        status land in ONE persister transaction, so a crash can never
        leave a pod half-recorded (reference: PersistentLaunchRecorder
        via DefaultScheduler.java:454-455).
        """
        ops = []
        for info in infos:
            ops.append(SetOp(self._task_path(info.name, "info"), info.to_bytes()))
            status = TaskStatus(
                task_id=info.task_id,
                state=TaskState.STAGING,
                agent_id=info.agent_id,
                message="launch recorded (WAL)",
            )
            ops.append(SetOp(self._task_path(info.name, "status"), status.to_bytes()))
        with self._lock:
            self._persister.apply(ops)
            self._bump_task_generation_locked()

    # -- task removal (decommission / GC) ----------------------------

    def clear_task(self, task_name: str) -> None:
        """Reference: StateStore.clearTask, used by EraseTaskStateStep."""
        try:
            self._persister.recursive_delete(self._task_path(task_name))
        except PersisterError:
            pass
        with self._lock:
            # keep the decode cache bounded: removed tasks never
            # come back under the same bytes-validated entries
            for leaf in ("info", "status"):
                self._decode_cache.pop(
                    self._task_path(task_name, leaf), None
                )
            self._bump_task_generation_locked()

    # -- goal-state overrides (pod pause/resume) ----------------------

    def store_goal_override(
        self,
        task_name: str,
        override: GoalStateOverride,
        progress: OverrideProgress,
    ) -> None:
        payload = json.dumps(
            {"override": override.value, "progress": progress.value}
        ).encode("utf-8")
        self._persister.set(self._task_path(task_name, "override"), payload)
        with self._lock:
            self._bump_task_generation_locked()

    def fetch_goal_override(
        self, task_name: str
    ) -> tuple[GoalStateOverride, OverrideProgress]:
        raw = self._persister.get_or_none(self._task_path(task_name, "override"))
        if raw is None:
            return (GoalStateOverride.NONE, OverrideProgress.COMPLETE)
        data = json.loads(raw.decode("utf-8"))
        return (
            GoalStateOverride(data["override"]),
            OverrideProgress(data["progress"]),
        )

    # -- properties ---------------------------------------------------

    def store_property(self, key: str, value: bytes) -> None:
        _validate_property_key(key)
        self._persister.set(f"{self._root}/properties/{key}", value)

    def fetch_property(self, key: str) -> Optional[bytes]:
        _validate_property_key(key)
        return self._persister.get_or_none(f"{self._root}/properties/{key}")

    def fetch_property_keys(self) -> List[str]:
        return self._persister.get_children_or_empty(f"{self._root}/properties")

    def clear_property(self, key: str) -> None:
        _validate_property_key(key)
        try:
            self._persister.recursive_delete(f"{self._root}/properties/{key}")
        except PersisterError:
            pass

    # -- deployment-completed bit ------------------------------------

    # Reference: StateStoreUtils.setDeploymentWasCompleted — records
    # that the initial deploy finished so scheduler restarts pick the
    # *update* plan rather than re-deploying (SchedulerBuilder.java:644).
    _DEPLOY_COMPLETED = "deployment-completed"

    def set_deployment_completed(self) -> None:
        self.store_property(self._DEPLOY_COMPLETED, b"true")

    def deployment_was_completed(self) -> bool:
        return self.fetch_property(self._DEPLOY_COMPLETED) == b"true"


def _validate_property_key(key: str) -> None:
    if not key or "/" in key:
        raise StateStoreException(f"invalid property key: {key!r}")
