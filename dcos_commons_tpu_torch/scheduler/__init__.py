"""L2 core: the service scheduler and its builder.

Reference: sdk/scheduler/.../scheduler/ — MesosEventClient.java:14-68
(the event contract), AbstractScheduler.java (reconcile gate, work-set
revive), DefaultScheduler.java:81 (offer->plan wiring :423-470,
unexpected-resource GC :483-538, status fan-out :541-568),
SchedulerBuilder.java:331 (persister/state/config wiring, deploy-vs-
update plan selection :644), SchedulerRunner.java:82.

Port of ``dcos_commons_tpu/scheduler/__init__.py``, line for line but the
imports.
"""

from dcos_commons_tpu_torch.scheduler.config import SchedulerConfig
from dcos_commons_tpu_torch.scheduler.scheduler import DefaultScheduler
from dcos_commons_tpu_torch.scheduler.builder import SchedulerBuilder

__all__ = ["DefaultScheduler", "SchedulerBuilder", "SchedulerConfig"]
