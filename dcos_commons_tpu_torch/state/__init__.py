"""L5 state: task/config/framework state over a Persister.

Reference: sdk/scheduler/.../state/ — StateStore.java:58,213-569,
ConfigStore.java, FrameworkStore.java, GoalStateOverride.java,
PersistentLaunchRecorder.java, SchemaVersionStore.java,
StateStoreUtils.java.

Port of ``dcos_commons_tpu/state/__init__.py``.
"""

from dcos_commons_tpu_torch.state.state_store import (
    GoalStateOverride,
    OverrideProgress,
    StateStore,
    StateStoreException,
)
from dcos_commons_tpu_torch.state.config_store import ConfigStore
from dcos_commons_tpu_torch.state.framework_store import FrameworkStore
from dcos_commons_tpu_torch.state.launch_recorder import PersistentLaunchRecorder
from dcos_commons_tpu_torch.state.schema import SchemaVersionStore

__all__ = [
    "ConfigStore",
    "FrameworkStore",
    "GoalStateOverride",
    "OverrideProgress",
    "PersistentLaunchRecorder",
    "SchemaVersionStore",
    "StateStore",
    "StateStoreException",
]
