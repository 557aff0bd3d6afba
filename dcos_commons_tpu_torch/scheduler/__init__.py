"""L2 core: the service scheduler.

Reference: sdk/scheduler/.../scheduler/ — MesosEventClient.java:14-68
(the event contract), AbstractScheduler.java (reconcile gate, work-set
revive), DefaultScheduler.java:81 (offer->plan wiring :423-470,
unexpected-resource GC :483-538, status fan-out :541-568).

Port of ``dcos_commons_tpu/scheduler/__init__.py`` but the builder
(``scheduler/builder.py``), which the port does not have yet: a
``DefaultScheduler`` is wired by hand from its parts.
"""

from dcos_commons_tpu_torch.scheduler.config import SchedulerConfig
from dcos_commons_tpu_torch.scheduler.scheduler import DefaultScheduler

__all__ = ["DefaultScheduler", "SchedulerConfig"]
