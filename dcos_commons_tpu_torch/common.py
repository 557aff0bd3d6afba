"""Core task-data types shared by every layer.

The reference smuggles this information inside Mesos protobufs
(``TaskInfo``/``TaskStatus``) plus labels (reference:
sdk/scheduler/src/main/java/com/mesosphere/sdk/offer/taskdata/,
LabelConstants.java:46,66).  The rebuild has no Mesos, so these are
plain serializable dataclasses owned by the framework itself.

Port of ``dcos_commons_tpu/common.py``,
line for line but the imports.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List


class TaskState(enum.Enum):
    """Task lifecycle states.

    Mirrors the Mesos TaskState vocabulary the reference consumes
    (reference: framework/FrameworkScheduler.java:273 status fan-in),
    with accelerator-fleet additions: PREEMPTED (host preemption) and
    MAINTENANCE (host entering maintenance) play the role the
    reference gives TASK_LOST + PARTITION_AWARE signals
    (FrameworkRunner.java:185-189).
    """

    STAGING = "TASK_STAGING"      # accepted, sandbox being provisioned
    STARTING = "TASK_STARTING"    # process launched, not yet healthy
    RUNNING = "TASK_RUNNING"
    FINISHED = "TASK_FINISHED"    # terminal, success (goal FINISH/ONCE)
    FAILED = "TASK_FAILED"        # terminal, nonzero exit
    KILLED = "TASK_KILLED"        # terminal, killed by scheduler
    LOST = "TASK_LOST"            # terminal, agent disappeared
    PREEMPTED = "TASK_PREEMPTED"  # terminal, host preempted
    ERROR = "TASK_ERROR"          # terminal, invalid task

    @property
    def is_terminal(self) -> bool:
        return self in _TERMINAL_STATES

    @property
    def is_failure(self) -> bool:
        """Terminal states that should trigger recovery."""
        return self in (
            TaskState.FAILED,
            TaskState.LOST,
            TaskState.PREEMPTED,
            TaskState.ERROR,
        )

    @property
    def is_running(self) -> bool:
        return self is TaskState.RUNNING


_TERMINAL_STATES = frozenset(
    {
        TaskState.FINISHED,
        TaskState.FAILED,
        TaskState.KILLED,
        TaskState.LOST,
        TaskState.PREEMPTED,
        TaskState.ERROR,
    }
)


def new_task_id(task_name: str) -> str:
    """``<name>__<uuid>`` task-id scheme (reference: offer/CommonIdUtils.java)."""
    return f"{task_name}__{uuid.uuid4().hex}"


def task_name_of(task_id: str) -> str:
    """Inverse of :func:`new_task_id`."""
    name, sep, _ = task_id.rpartition("__")
    if not sep:
        raise ValueError(f"not a task id: {task_id!r}")
    return name


# ---------------------------------------------------------------------------
# Serialization helpers (JSON <-> dataclasses, enum-aware)
# ---------------------------------------------------------------------------


def _to_jsonable(value: Any) -> Any:
    if isinstance(value, enum.Enum):
        return value.value
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {
            f.name: _to_jsonable(getattr(value, f.name))
            for f in dataclasses.fields(value)
        }
    if isinstance(value, dict):
        return {k: _to_jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_to_jsonable(v) for v in value]
    return value


class SerializableMixin:
    """JSON round-tripping for the task-data dataclasses."""

    def to_dict(self) -> Dict[str, Any]:
        return _to_jsonable(self)

    def to_bytes(self) -> bytes:
        return json.dumps(self.to_dict(), sort_keys=True).encode("utf-8")

    @classmethod
    def from_dict(cls, data: Dict[str, Any]):
        kwargs: Dict[str, Any] = {}
        hints = {f.name: f for f in dataclasses.fields(cls)}
        for key, value in data.items():
            if key not in hints:
                continue  # forward compatibility: ignore unknown fields
            kwargs[key] = _coerce(hints[key].type, value)
        return cls(**kwargs)

    @classmethod
    def from_bytes(cls, raw: bytes):
        return cls.from_dict(json.loads(raw.decode("utf-8")))


def _coerce(type_name: Any, value: Any) -> Any:
    # dataclass field types arrive as strings (PEP 563 style annotations).
    if value is None:
        return None
    name = type_name if isinstance(type_name, str) else getattr(type_name, "__name__", "")
    if "TaskState" in name:
        return TaskState(value)
    if "TaskInfo" in name and isinstance(value, dict):
        return TaskInfo.from_dict(value)
    if "List[TaskInfo]" in name and isinstance(value, list):
        return [TaskInfo.from_dict(v) for v in value]
    return value


# ---------------------------------------------------------------------------
# TaskInfo / TaskStatus
# ---------------------------------------------------------------------------


@dataclass
class TaskInfo(SerializableMixin):
    """Everything the scheduler decided about one launched task.

    The reference assembles the equivalent Mesos proto in
    PodInfoBuilder (offer/evaluate/PodInfoBuilder.java, 831 LoC) and
    stores per-task metadata in labels (offer/taskdata/).  Here the
    labels are first-class fields.
    """

    name: str                       # "<pod>-<index>-<task>"
    task_id: str = ""
    agent_id: str = ""              # host the task was placed on
    pod_type: str = ""
    pod_index: int = 0
    command: str = ""
    env: Dict[str, str] = field(default_factory=dict)
    # resource ids from the reservation ledger (reference: resource-id
    # labels stamped by offer/ResourceBuilder.java)
    resource_ids: List[str] = field(default_factory=list)
    # the reserved cards' ids ("<host_id>/<k>"); the field keeps the
    # JAX package's name, since its JSON is the state store's format
    tpu_chip_ids: List[str] = field(default_factory=list)
    volume_ids: List[str] = field(default_factory=list)
    # container_path -> durable volume key; the agent materializes each
    # as a persistent directory symlinked into the sandbox, so TRANSIENT
    # relaunches (same reservation -> same key) reattach their data and
    # PERMANENT replaces (fresh reservation -> fresh key) start empty
    volumes: Dict[str, str] = field(default_factory=dict)
    # labels carry the remaining metadata the reference keeps in
    # offer/taskdata/LabelConstants.java: target config id, readiness
    # spec, permanently-failed flag, hostname/zone of launch...
    labels: Dict[str, str] = field(default_factory=dict)

    def with_label(self, key: str, value: str) -> "TaskInfo":
        info = dataclasses.replace(
            self,
            env=dict(self.env),
            resource_ids=list(self.resource_ids),
            tpu_chip_ids=list(self.tpu_chip_ids),
            volume_ids=list(self.volume_ids),
            volumes=dict(self.volumes),
            labels={**self.labels, key: value},
        )
        return info


@dataclass
class TaskStatus(SerializableMixin):
    """One status update for a task (reference: Mesos TaskStatus)."""

    task_id: str
    state: TaskState
    message: str = ""
    agent_id: str = ""
    timestamp: float = 0.0
    # readiness-check-passed travels on the status, mirroring the
    # reference's readiness label flow (PodInfoBuilder.java:511-526).
    ready: bool = False
    container_ip: str = ""

    def __post_init__(self) -> None:
        if isinstance(self.state, str):
            self.state = TaskState(self.state)
        if not self.timestamp:
            self.timestamp = time.time()


def atomic_write_text(path: str, content: str) -> None:
    """Write-tmp-fsync-then-rename so readers never see a partial
    file AND the content survives a power failure at the rename
    (announce files, PID files)."""
    import os

    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(content)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class Label:
    """Well-known label keys (reference: offer/taskdata/LabelConstants.java)."""

    TARGET_CONFIG = "target_configuration"
    READINESS_CHECK_PASSED = "readiness_check_passed"
    PERMANENTLY_FAILED = "permanently_failed"
    DECOMMISSIONED = "decommissioned"
    HOSTNAME = "offer_hostname"
    ZONE = "offer_zone"
    REGION = "offer_region"
    GOAL_STATE = "goal_state"
    GOAL_STATE_OVERRIDE = "goal_state_override"
    NETWORKS = "networks"
    SHARE_PID_NAMESPACE = "share_pid_namespace"
