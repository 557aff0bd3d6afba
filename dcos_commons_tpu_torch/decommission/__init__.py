"""Decommission: planned scale-down of pod instances.

Reference: scheduler/decommission/ — DecommissionPlanFactory builds
kill -> unreserve -> erase step sequences for pod instances that the
target config no longer covers (count shrunk, or the whole pod type
removed); resources drain through the same write-ahead discipline as
uninstall (DefaultScheduler.java:170-177,456-459,527-536).

Port of ``dcos_commons_tpu/decommission/__init__.py``,
line for line but the imports.
"""

from dcos_commons_tpu_torch.decommission.factory import (
    DECOMMISSION_PLAN_NAME,
    DecommissionPlanFactory,
    find_surplus_instances,
)

__all__ = [
    "DECOMMISSION_PLAN_NAME",
    "DecommissionPlanFactory",
    "find_surplus_instances",
]
