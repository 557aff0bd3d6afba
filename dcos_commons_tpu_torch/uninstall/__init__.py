"""Uninstall: full service teardown as a plan.

Reference: scheduler/uninstall/ — UninstallScheduler (291 LoC),
UninstallPlanFactory (phases: kill tasks -> unreserve resources ->
deregister), UninstallRecorder write-ahead of dereservations,
skeleton scheduler when already uninstalled
(framework/FrameworkRunner.java:99-115,214-238).

Port of ``dcos_commons_tpu/uninstall/__init__.py``, line for line but the imports.
"""

from dcos_commons_tpu_torch.uninstall.scheduler import (
    UNINSTALL_PLAN_NAME,
    UninstallPlanFactory,
    UninstallScheduler,
)

__all__ = [
    "UNINSTALL_PLAN_NAME",
    "UninstallPlanFactory",
    "UninstallScheduler",
]
