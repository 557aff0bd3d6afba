"""L2: failure recovery — synthesized plans for crashed/lost tasks.

Reference: sdk/scheduler/.../scheduler/recovery/ —
DefaultRecoveryPlanManager.java:53,142,164,378-420 (plan synthesized
on the fly from failed tasks; escalation TRANSIENT -> PERMANENT),
RecoveryType.java:7-25, monitor/ (NeverFailureMonitor,
TimedFailureMonitor.java:20-60, TestingFailureMonitor),
FailureUtils (permanently-failed task labels),
RecoveryPlanOverrider hook (CassandraRecoveryPlanOverrider.java:38).

GPU mapping (SURVEY.md section 5.3): preemption/maintenance events play
TASK_LOST; PERMANENT recovery of a gang pod = re-place the node set
and restart from checkpoint; one lost worker flips the WHOLE gang to
recovery (the gang's process group cannot run degraded).

Port of ``dcos_commons_tpu/recovery/__init__.py``,
line for line but the imports.
"""

from dcos_commons_tpu_torch.recovery.monitor import (
    FailureMonitor,
    NeverFailureMonitor,
    TestingFailureMonitor,
    TimedFailureMonitor,
)
from dcos_commons_tpu_torch.recovery.manager import (
    DefaultRecoveryPlanManager,
    RecoveryPlanOverrider,
)

__all__ = [
    "DefaultRecoveryPlanManager",
    "FailureMonitor",
    "NeverFailureMonitor",
    "RecoveryPlanOverrider",
    "TestingFailureMonitor",
    "TimedFailureMonitor",
]
